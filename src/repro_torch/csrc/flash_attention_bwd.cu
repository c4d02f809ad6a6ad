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
//   dk, dv     (B, T, hk, hd / hdv) T  contiguous
//   fp32: dsum (B, h, S) fp32 scratch, D = rowsum(dout * out)
//   bf16: work, flash_attention_bwd_bf16_workspace bytes, uninitialised
//         (bwd_rowstats zeroes the counters of the ordered dQ)
// (hd, hdv) is (64, 64), (128, 128) or MLA's (192, 128).  Query s sits at
// position s + T - S; the mask and the scale (1/sqrt(hd)) are the forward's.
// Rows are position-major across the g = h / hk heads of a kv head's group
// (row r = s g + member, at position r / g + T - S), as the forward takes
// them, so every K/V tile serves the whole group.
//
// Math (FlashAttention-2): D = rowsum(dO o O); P = exp(S scale - lse);
// dV = P^T dO with P rounded to T for the product (the forward rounds it so);
// dP = dO V^T; dS = P o (dP - D); dQ = dS K scale; dK = dS^T Q scale, dS
// rounded to T for the three products.  Scores, softmax and every
// accumulator in fp32; never TF32 (the fp32 card-vs-CPU gates rest on it).
//
// Bound.  Operations: 10 hd per visible (query head row, key) pair (the
// score product S, dP, dV, dK and dQ), at the tensor cores' bf16 rate; the
// bytes (q, k, v, out, dout read once, dq, dk, dv written once) are far
// smaller at the training shapes.  So the design keeps the tensor cores fed
// and computes each product once where it can.
//
// bf16 (the path training runs), FlashAttention-3's backward:
//  * bwd_rowstats: D and lse log2(e) of every row, in row order a (batch, kv
//    head), rows rounded up to 128 (padding rows +inf and 0: their P and dS
//    are 0); it also zeroes the ordered dQ's counters.
//  * bwd_ws, the gradient: one block a 128-key block of a (batch, kv head),
//    warp-specialised: a producer warpgroup that gives its registers to two
//    consumer warpgroups (setmaxnreg).  Its warp 0 loads the block's K and V
//    once and keeps a ring of two Q/dO tiles (64 rows; 32 at MLA's widths)
//    with their row statistics in flight: TMA boxes where the tile's rows
//    are one box (g divides the tile: g heads x tile / g positions), else
//    16-byte cp.async of its lanes; an mbarrier says a stage is full,
//    another that both consumers are done with it.  Each consumer
//    warpgroup owns 64 keys (the M of its products): S^T = K Q^T and dP^T =
//    V dO^T from shared memory, P^T and dS^T in registers, dV += P^T dO and
//    dK += dS^T Q with P^T and dS^T as register operands.  dK and dV stay
//    in registers and are written once.  Rows are walked from the last tile
//    to the first.  (Issuing tile i + 1's products before tile i's last one
//    retires made ptxas serialize the wgmmas here: the loop does not.)
//  * dQ (ordered_dq), at q/k widths 64 and 128: not recomputed.  Both
//    warpgroups write dS^T to shared memory (named barrier 1); each
//    computes its share of the tile's 64-wide hd slices of dQ^T = K^T dS^T
//    over the block's 128 keys (transposed shared-memory operands) into an
//    fp32 buffer; warp 1 of the producer adds the buffer to a global fp32
//    sum with one bulk reduce-add, in key-block order (below), while the
//    consumers go on (two buffers); bwd_dq_out scales and rounds the sum
//    into q's layout.  At MLA's (192, 128) the 32-row tiles make twice the
//    adds of 48 KB rows, which cost more than recomputing: bwd_dq_ws, in
//    bwd_ws's shape with 128 rows a block (64 a consumer warpgroup) against
//    64-key tiles, recomputes S and dP (tile i + 1's issued before tile
//    i's dQ product retires) and keeps dQ += dS K in registers; bwd_ws then
//    computes dK and dV alone.  launch/probe_flash_bwd.py times
//    both designs at every width (the probe build -DFLASH_BWD_OTHER_DQ).
//
// The ordered dQ (FlashAttention-3's deterministic mode).  Each (batch, kv
// head, row tile) has a counter in the workspace.  A block adds its partial
// to a row tile only when the counter equals the number of key blocks
// before it that see that tile, then bumps it (release after the bulk add
// has completed; the next block's acquire comes before its own add); the
// first key block stores its partial, so the sums need no zeroing.  So
// every element of dQ is summed in key-block order whatever the timing, and
// two calls give the same bits.  It cannot deadlock: a block takes its key
// block from a ticket (an atomic counter in the workspace), key blocks in
// ascending order with (batch, kv head) innermost; it waits only on lower
// key blocks of its own (batch, kv head), whose tickets were taken earlier
// by blocks that are already running, and the lowest unfinished ticket
// waits on nothing.  Walking the rows from the last tile keeps the blocks of
// a causal (batch, kv head) in step: each reaches a row tile one add after
// the block before it (walking from the first tile, block n would wait 2n
// tiles for block 0), and the longest key blocks start first.
//
// The schedule: a block's range of tiles comes from rows_seeing / keys_seen,
// and each warp decides on every 16-row x 16-key unit whether to mask it
// (unit_state: 1 every pair visible, else masked).  The three are
// kernels/flash_attention.py's bwd_rows, bwd_keys and bwd_unit_state line
// for line; the CPU tests hold those against a brute-force mask.
//
// fp32: FMA kernels in the shape of flash_attention.cu's flash_fwd_kernel
// (a 16 x 16 thread grid, tiles of 32 rows and 32 keys in shared memory):
// dq by row tiles (it writes D), then dk/dv by key tiles, no atomics.
//
// Shared memory above 48 KB is set once per device by
// flash_attention_bwd_init (the wrapper calls it on a device's first
// launch): no launch sets an attribute, and nothing here is static.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnit = 16;   // rows and keys of the unit a warp masks or not

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
template <class A>
__device__ __forceinline__ void rows_seeing(const A& a, int g, int k0, int k1, int& lo, int& hi) {
  const int off = a.T - a.S;
  const int p_lo = a.causal ? k0 : off;
  const int p_hi = a.window > 0 ? k1 - 1 + a.window - 1 : off + a.S - 1;
  const int s_lo = max(0, p_lo - off), s_hi = min(a.S - 1, p_hi - off);
  lo = s_lo <= s_hi ? s_lo * g : 0;
  hi = s_lo <= s_hi ? (s_hi + 1) * g : 0;
}

// keys [lo, hi) that some row of [r0, r1) sees (r1 <= g S)
template <class A>
__device__ __forceinline__ void keys_seen(const A& a, int g, int r0, int r1, int& lo, int& hi) {
  const int off = a.T - a.S;
  const int p_lo = r0 / g + off, p_hi = (r1 - 1) / g + off;
  const int k_hi = a.causal ? min(a.T - 1, p_hi) : a.T - 1;
  const int k_lo = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
  lo = k_lo <= k_hi ? k_lo : 0;
  hi = k_lo <= k_hi ? k_hi + 1 : 0;
}

// rows [r0, r1) against keys [k0, k1) (both clipped to the valid ones):
// 0 no pair visible, 1 every pair visible, 2 some (a mask)
template <class A>
__device__ __forceinline__ int unit_state(const A& a, int g, int r0, int r1, int k0, int k1) {
  if (r0 >= r1 || k0 >= k1) return 0;
  const int off = a.T - a.S;
  const int p_lo = r0 / g + off, p_hi = (r1 - 1) / g + off;
  const bool any = (!a.causal || k0 <= p_hi) && (a.window <= 0 || k1 - 1 > p_lo - a.window);
  if (!any) return 0;
  const bool all = (!a.causal || k1 - 1 <= p_lo) && (a.window <= 0 || k0 > p_hi - a.window);
  return all ? 1 : 2;
}

template <class A>
__device__ __forceinline__ bool visible(const A& a, int key, int qpos) {
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

// ======================= bf16: warp-specialised wgmma =======================

constexpr int kKeyBlock = 128;     // keys a block: 64 for each consumer warpgroup
constexpr int kStages = 2;         // Q/dO tiles in flight
constexpr int kThreadsWs = 384;    // the producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 128 x 40 + 256 x 232 <= 64 K

// rows a staged Q/dO tile (the N of the score products, the M of dQ^T's
// store): 32 at MLA's widths, where dK (64 x 192) and dV (64 x 128) hold
// 160 of a consumer thread's registers
__host__ __device__ constexpr int row_tile(int hd) { return hd > 128 ? 32 : 64; }

// the block's shared memory, byte offsets from a 1024-aligned base (each
// tile in the 128-byte-swizzled layout of sm90::swz, 1024-aligned)
template <int HD, int HDV>
struct WsSmem {
  static constexpr int QT = row_tile(HD), KB = kKeyBlock;
  static constexpr size_t k = 0;                                    // K [KB][HD]
  static constexpr size_t v = k + (size_t)KB * HD * 2;              // V [KB][HDV]
  static constexpr size_t stage = v + (size_t)KB * HDV * 2;         // [kStages][Q [QT][HD], dO [QT][HDV]]
  static constexpr size_t stage_bytes = (size_t)QT * (HD + HDV) * 2;
  static constexpr size_t ds = stage + kStages * stage_bytes;       // [2][dS^T [KB][QT]] bf16
  static constexpr size_t ds_bytes = (size_t)KB * QT * 2;
  static constexpr size_t dq = ds + 2 * ds_bytes;                   // [2][QT HD] fp32, fragment order
  static constexpr size_t dq_bytes = (size_t)QT * HD * 4;
  static constexpr size_t stats = dq + 2 * dq_bytes;                // [kStages][lse2 [QT], D [QT]]
  static constexpr size_t bars = stats + (size_t)kStages * QT * 8;  // the mbarriers below
  static constexpr int n_bars = 1 + 2 * kStages + 4;                // kv, full, empty, dq full, dq empty
  static constexpr size_t total = bars + 8 * n_bars + 1024;         // + the alignment of the base
};

struct WsArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* out;
  const bf16* dout;
  const float* lse;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse2;     // (B, hk, rpad): lse log2(e) of each row
  float* dsum;     // (B, hk, rpad): D of each row
  float* dq_acc;   // (B, hk, n_rt, QT HD): the ordered sums of dQ, fragment order
  int* sem;        // [ticket, (B, hk, n_rt) counters]
  int B, S, T, h, hk, n_rt, rpad;   // row tiles, rows rounded up to 128
  long long k_bs, k_ss, v_bs, v_ss;
  int causal, window, tma_rows;   // tma_rows: the Q/dO tiles by TMA (g divides QT)
  float scale;
};

// How dQ is computed at q/k width hd: summed over the key blocks in key
// order inside bwd_ws (64 and 128), or by bwd_dq_ws, a kernel of the same
// shape that recomputes S and dP (MLA's 192: there the ordered adds of
// 32-row tiles cost more than the recomputation; PERF.md has both designs'
// times).  The probe build -DFLASH_BWD_OTHER_DQ takes the other design at
// every width, for launch/probe_flash_bwd.py's comparison.
__host__ __device__ constexpr bool ordered_dq(int hd) {
#ifdef FLASH_BWD_OTHER_DQ
  return hd > 128;
#else
  return hd <= 128;
#endif
}

// the workspace of a bf16 call: counters, row statistics, dQ sums (bytes)
struct Workspace {
  size_t lse2, dsum, dq_acc, bytes;
};
inline Workspace workspace(int B, int S, int h, int hk, int hd) {
  const int qt = row_tile(hd), rows = (h / hk) * S, n_rt = (rows + qt - 1) / qt;
  const size_t nbh = (size_t)B * hk, rpad = (size_t)(rows + 127) / 128 * 128;
  const bool ordered = ordered_dq(hd);
  Workspace w;
  w.lse2 = ordered ? ((1 + nbh * n_rt) * 4 + 15) / 16 * 16 : 0;
  w.dsum = w.lse2 + nbh * rpad * 4;
  w.dq_acc = w.dsum + nbh * rpad * 4;
  w.bytes = w.dq_acc + (ordered ? nbh * n_rt * qt * hd * 4 : 0);
  return w;
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

// S^T = K Q^T and dP^T = V dO^T of the staged tile at qs (Q [QT][HD], then
// dO [QT][HDV]): the warpgroup's 64 keys (rows 64 wg of the block's K and V
// tiles) against the tile's rows; one commit group each
template <int HD, int HDV, int QT>
__device__ __forceinline__ void score_products(float (&s)[QT / 8][4], float (&dp)[QT / 8][4],
                                               uint32_t ks, uint32_t vs, uint32_t qs, int wg) {
  const uint32_t dos = qs + QT * HD * 2;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    wgmma_ss<QT>(s, desc_k_major<HD, kKeyBlock>(ks, kc, wg * 64), desc_k_major<HD, QT>(qs, kc, 0),
                 kc);
  wgmma_commit();
#pragma unroll
  for (int dc = 0; dc < HDV / 16; ++dc)
    wgmma_ss<QT>(dp, desc_k_major<HDV, kKeyBlock>(vs, dc, wg * 64),
                 desc_k_major<HDV, QT>(dos, dc, 0), dc);
  wgmma_commit();
}

// one 64-wide hd slice of dQ^T = K^T dS^T (the slice's column of the K
// tile at k_slice, read M-major; dS^T [key][row] at ds) over the block's
// keys, into acc (issued, not committed)
template <int HD, int QT>
__device__ __forceinline__ void dq_slice(float (&acc)[QT / 8][4], uint32_t k_slice, uint32_t ds) {
#pragma unroll
  for (int kk = 0; kk < kKeyBlock / 16; ++kk)
    wgmma_ss_tt<QT>(acc, desc_mn_major<HD, kKeyBlock>(k_slice, kk),
                    desc_mn_major<QT, kKeyBlock>(ds, kk), kk);
}

// a dQ^T slice into the buffer in fragment order: thread (warp, lane)'s
// float pairs side by side (bwd_dq_out reads them back)
template <int QT>
__device__ __forceinline__ void store_slice(float2* buf, const float (&acc)[QT / 8][4], int at,
                                            int warp, int lane) {
#pragma unroll
  for (int n = 0; n < QT / 8; ++n)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      buf[((at * 4 + warp) * (QT / 4) + 2 * n + hi) * 32 + lane] =
          make_float2(acc[n][2 * hi], acc[n][2 * hi + 1]);
}

// D and lse log2(e) of each row of a (batch, kv head), one warp a row, in
// row order; rows past g S (the last tile's padding) get D 0, lse +inf
template <int HD, int HDV>
__global__ void __launch_bounds__(256) bwd_rowstats(WsArgs a) {
  const int g = a.h / a.hk, rows = g * a.S, padded = a.rpad;
  const long long i = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // the ordered dQ's ticket and counters (a thread each: the grid has 32
  // threads a row, more than the counters)
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  if (ordered_dq(HD) && t <= (long long)a.B * a.hk * a.n_rt) a.sem[t] = 0;
  if (i >= (long long)a.B * a.hk * padded) return;
  const int bh = (int)(i / padded), r = (int)(i % padded);
  const int b = bh / a.hk, kvh = bh % a.hk;
  float d = 0.f, l2 = INFINITY;
  if (r < rows) {
    // each lane sums its pairs of values in order, then the warp's butterfly
    const size_t o = row_off(b, r, g, kvh, a.S, a.h, HDV);
    float part = 0.f;
    for (int c = lane * 2; c < HDV; c += 64) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.dout + o + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.out + o + c));
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
    }
    d = warp_sum(part);
    l2 = a.lse[vec_off(b, r, g, kvh, a.S, a.h)] * kLog2e;
  }
  if (lane == 0) {
    a.dsum[i] = d;
    a.lse2[i] = l2;
  }
}

// ORDERED (ordered_dq): dQ's partials summed here; else dK and dV alone,
// bwd_dq_ws computing dQ
template <int HD, int HDV, bool ORDERED>
__global__ void __launch_bounds__(kThreadsWs, 1)
    bwd_ws(const __grid_constant__ WsArgs a, const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_do, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v) {
  using L = WsSmem<HD, HDV>;
  constexpr int QT = L::QT, KB = kKeyBlock;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int item_s;
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  const uint32_t bar_kv = sb + (uint32_t)L::bars;
  // the ring's full and empty barriers, then the dQ buffers' full and empty ones
  auto bar_full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8 * (1 + kStages + s); };
  auto bar_dq_full = [&](int j) { return bar_kv + 8 * (1 + 2 * kStages + j); };
  auto bar_dq_empty = [&](int j) { return bar_kv + 8 * (3 + 2 * kStages + j); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    // the ticket of the ordered adds (see the header note); without them the
    // block's own index
    item_s = ORDERED ? atomicAdd(a.sem, 1) : (int)blockIdx.x;
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), a.tma_rows ? 1 : 32);
      mbar_init(bar_empty(s), 8);   // every consumer warp
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(bar_dq_full(j), 8);
      mbar_init(bar_dq_empty(j), 1);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // warp-uniform values broadcast with a shuffle, so the compiler sees the
  // roles' branches as uniform and keeps the wgmma asynchronous
  const int item = __shfl_sync(0xffffffffu, item_s, 0);
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int nbh = a.B * a.hk, bh = item % nbh, kb = item / nbh;
  const int b = bh / a.hk, kvh = bh % a.hk;
  const int g = a.h / a.hk, rows = g * a.S;
  const int k0b = kb * KB, nk = min(KB, a.T - k0b);
  int r_lo, r_hi;
  rows_seeing(a, g, k0b, k0b + nk, r_lo, r_hi);
  // the row tiles that see the block's keys, walked from the last one
  const int t_last = r_hi > r_lo ? (r_hi - 1) / QT : 0;
  const int n_tiles = r_hi > r_lo ? t_last - r_lo / QT + 1 : 0;

  if (role == 0) {
    // ---- the producer warpgroup: warp 0 loads, warp 1 adds dQ
    setmaxnreg_dec<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
    if (warp == 0 && n_tiles > 0) {
      if (lane == 0) {
        // the block's K and V: a box of 64 values x 128 keys for each
        // 64-wide column; keys past T are zeros
        mbar_expect_tx(bar_kv, KB * (HD + HDV) * 2);
        for (int c = 0; c < HD / 64; ++c)
          tma_load_4d(sb + L::k + c * KB * 128, &tm_k, bar_kv, c * 64, kvh, k0b, b);
        for (int c = 0; c < HDV / 64; ++c)
          tma_load_4d(sb + L::v + c * KB * 128, &tm_v, bar_kv, c * 64, kvh, k0b, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, rt0 = (t_last - i) * QT;
        const uint32_t qs = sb + L::stage + st * L::stage_bytes, dos = qs + QT * HD * 2;
        const uint32_t stats = sb + L::stats + st * QT * 8;
        const size_t srow = (size_t)bh * a.rpad + rt0;
        mbar_wait(bar_empty(st), ((i / kStages) & 1) ^ 1);
        if (a.tma_rows) {
          // rows s g + member: g heads x QT / g positions, one box a
          // 64-wide column; positions past S are zeros
          if (lane == 0) {
            mbar_expect_tx(bar_full(st), QT * (HD + HDV) * 2 + QT * 8);
            for (int c = 0; c < HD / 64; ++c)
              tma_load_4d(qs + c * QT * 128, &tm_q, bar_full(st), c * 64, kvh * g, rt0 / g, b);
            for (int c = 0; c < HDV / 64; ++c)
              tma_load_4d(dos + c * QT * 128, &tm_do, bar_full(st), c * 64, kvh * g, rt0 / g, b);
            bulk_load(stats, a.lse2 + srow, QT * 4, bar_full(st));
            bulk_load(stats + QT * 4, a.dsum + srow, QT * 4, bar_full(st));
          }
        } else {
          // the tile's rows span positions: 16 bytes a lane, zeros past the
          // last row; the lanes wait for their own copies, then arrive
          for (int j = lane; j < QT * (HD / 8); j += 32) {
            const int r = j / (HD / 8), ch = j % (HD / 8);
            const bool ok = rt0 + r < rows;
            cp_async16(qs + swz<HD, QT>(r, ch),
                       ok ? a.q + row_off(b, rt0 + r, g, kvh, a.S, a.h, HD) + ch * 8 : a.q, ok);
          }
          for (int j = lane; j < QT * (HDV / 8); j += 32) {
            const int r = j / (HDV / 8), ch = j % (HDV / 8);
            const bool ok = rt0 + r < rows;
            cp_async16(dos + swz<HDV, QT>(r, ch),
                       ok ? a.dout + row_off(b, rt0 + r, g, kvh, a.S, a.h, HDV) + ch * 8 : a.dout,
                       ok);
          }
          for (int j = lane; j < QT / 2; j += 32) {   // lse2, then D: 4 rows a chunk
            const int half = j / (QT / 4), ch = j % (QT / 4);
            cp_async16(stats + half * QT * 4 + ch * 16, (half ? a.dsum : a.lse2) + srow + ch * 4,
                       true);
          }
          cp_async_commit();
          cp_async_wait<0>();
          fence_proxy_async();   // the tiles are read next by wgmma (the async proxy)
          mbar_arrive(bar_full(st));
        }
      }
    } else if (ORDERED && warp == 1) {
      for (int i = 0; i < n_tiles; ++i) {
        const int j = i & 1, rt = t_last - i;
        mbar_wait(bar_dq_full(j), (i >> 1) & 1);
        if (lane == 0) {
          // this block's turn: every key block before it that sees the
          // tile has added (they form one range, from keys_seen's first)
          int k_lo, k_hi;
          keys_seen(a, g, rt * QT, min(rt * QT + QT, rows), k_lo, k_hi);
          int* sem = a.sem + 1 + (size_t)bh * a.n_rt + rt;
          const int turn = kb - k_lo / KB;
          while (ld_acquire_gpu(sem) != turn) __nanosleep(64);
          fence_proxy_async_global();
          float* dst = a.dq_acc + ((size_t)bh * a.n_rt + rt) * QT * HD;
          const uint32_t src = sb + L::dq + j * L::dq_bytes;
          if (turn == 0) bulk_store(dst, src, (uint32_t)L::dq_bytes);   // the first
          else bulk_reduce_add_f32(dst, src, (uint32_t)L::dq_bytes);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(bar_dq_empty(j));   // the buffer is read: the consumers may refill it
          bulk_wait();
          fence_proxy_async_global();
          red_release_gpu_add(sem, 1);
        }
        __syncwarp();
      }
    }
    return;
  }

  // ---- the two consumer warpgroups: warpgroup wg owns keys 64 wg .. 64 wg + 63
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = role - 1, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int off = a.T - a.S;
  const float scale_log2 = a.scale * kLog2e;
  const int kw0 = k0b + wg * 64 + warp * 16, kw1 = min(kw0 + 16, a.T);   // the warp's keys
  const uint32_t ks = sb + L::k, vs = sb + L::v;
  float dk[HD / 8][4], dv[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

  if (n_tiles > 0) mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, j = i & 1, rt0 = (t_last - i) * QT;
    const uint32_t qs = sb + L::stage + st * L::stage_bytes, dos = qs + QT * HD * 2;
    const float* lse_t = reinterpret_cast<const float*>(base + L::stats + st * QT * 8);
    const float* d_t = lse_t + QT;
    mbar_wait(bar_full(st), (i / kStages) & 1);
    float s[QT / 8][4], dp[QT / 8][4];
    score_products<HD, HDV, QT>(s, dp, ks, vs, qs, wg);
    wgmma_wait<1>();   // S^T (groups end in order)
    // P^T in place of S^T: unmasked on the warp's units every pair of which
    // is visible (all of them when the whole tile is)
    const bool tile_full = unit_state(a, g, rt0, min(rt0 + QT, rows), kw0, kw1) == 1 &&
                           kw0 + kUnit <= a.T;
#pragma unroll
    for (int u = 0; u < QT / kUnit; ++u) {
      const int ur0 = rt0 + u * kUnit;
      const bool full = tile_full || (unit_state(a, g, ur0, min(ur0 + kUnit, rows), kw0, kw1) == 1 &&
                                      kw0 + kUnit <= a.T);
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
    // dS^T in place of dP^T, 16 rows at a time, each chunk packed at once
    // into the bf16 A operands of dV += P^T dO and dK += dS^T Q (so P^T and
    // dP^T die as they go), and dS^T into the tile's buffer ([key][row]),
    // the B operand of dQ^T
    uint32_t pa[QT / 16][4], da[QT / 16][4];
    unsigned char* ds_p = base + L::ds + j * L::ds_bytes;
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
      for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = s[nt][e] * (dp[nt][e] - d_t[nt * 8 + (lane & 3) * 2 + (e & 1)]);
      pack_a(pa[kk], s, kk);
      pack_a(da[kk], dp, kk);
      if constexpr (ORDERED) {
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int key = wg * 64 + warp * 16 + (lane >> 2) + 8 * (q4 & 1);
          *reinterpret_cast<uint32_t*>(ds_p + swz<QT, KB>(key, 2 * kk + (q4 >> 1)) +
                                       4 * (lane & 3)) = da[kk][q4];
        }
      }
    }
    if constexpr (ORDERED) {
      fence_proxy_async();      // dS^T is read next by wgmma
      named_bar_sync(1, 256);   // both warpgroups' dS^T are in
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) rs_product<HDV, QT>(dv, pa[kk], dos, kk);
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) rs_product<HD, QT>(dk, da[kk], qs, kk);
    wgmma_commit();
    if constexpr (!ORDERED) {
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(st));
      continue;
    }
    // dQ^T = K^T dS^T over the block's 128 keys, 64 values of hd (a slice)
    // at a time: warpgroup wg takes the slices of parity (i + wg) % 2, so an
    // odd count alternates between the two tile by tile
    const uint32_t ds_s = sb + L::ds + j * L::ds_bytes;
    float2* dq_b = reinterpret_cast<float2*>(base + L::dq + j * L::dq_bytes);
    for (int at = (i + wg) & 1, first = 1; first || at < HD / 64; at += 2, first = 0) {
      const bool slice = at < HD / 64;
      float acc[QT / 8][4];
      if (slice) {
        wgmma_fence();
        dq_slice<HD, QT>(acc, ks + at * KB * 128, ds_s);
        wgmma_commit();
      }
      wgmma_wait<0>();
      if (first) {   // the stage is read (dV, dK done): free it; wait for the dQ buffer
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(st));
        mbar_wait(bar_dq_empty(j), ((i >> 1) & 1) ^ 1);
      }
      if (slice) store_slice<QT>(dq_b, acc, at, warp, lane);
    }
    fence_proxy_async();   // the buffer is read next by the bulk add (the async proxy)
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_dq_full(j));
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int key = kw0 + (lane >> 2) + 8 * e2;
    if (key >= a.T) continue;
    const size_t row = ((size_t)b * a.T + key) * a.hk + kvh;
    bf16* dst_k = a.dk + row * HD + (lane & 3) * 2;
    bf16* dst_v = a.dv + row * HDV + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst_k + n * 8) =
          pack_bf16(dk[n][2 * e2] * a.scale, dk[n][2 * e2 + 1] * a.scale);
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst_v + n * 8) = pack_bf16(dv[n][2 * e2], dv[n][2 * e2 + 1]);
  }
}

// dQ = the ordered sum x scale, rounded to bf16: one block a (row tile,
// batch x kv head), the tile's fragment order turned into rows in shared
// memory, then written a row at a time
template <int HD>
__global__ void __launch_bounds__(256) bwd_dq_out(WsArgs a) {
  constexpr int QT = row_tile(HD), NP = QT / 4;
  __shared__ float tile[QT][HD + 4];
  const int rt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.hk, kvh = bh % a.hk, g = a.h / a.hk, rows = g * a.S;
  const float2* src =
      reinterpret_cast<const float2*>(a.dq_acc + ((size_t)bh * a.n_rt + rt) * QT * HD);
  for (int f = threadIdx.x; f < QT * HD / 2; f += 256) {
    // float pair f = ((slice * 4 + warp) * NP + p) * 32 + lane, p = 2 n + hi:
    // hd 64 slice + 16 warp + lane / 4 + 8 hi, rows 8 n + 2 (lane % 4) + {0, 1}
    const int l = f & 31, p = (f >> 5) % NP, sw = (f >> 5) / NP;
    const int col = (sw >> 2) * 64 + (sw & 3) * 16 + (l >> 2) + 8 * (p & 1);
    const int row = 8 * (p >> 1) + 2 * (l & 3);
    const float2 x = src[f];
    tile[row][col] = x.x;
    tile[row + 1][col] = x.y;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QT * HD / 2; i += 256) {
    const int row = i / (HD / 2), c = (i % (HD / 2)) * 2, r = rt * QT + row;
    if (r >= rows) continue;
    *reinterpret_cast<uint32_t*>(a.dq + row_off(b, r, g, kvh, a.S, a.h, HD) + c) =
        pack_bf16(tile[row][c] * a.scale, tile[row][c + 1] * a.scale);
  }
}

// dQ by a kernel of its own (ordered_dq false: MLA's widths), in bwd_ws's
// shape with rows as the M of its products: a block 128 rows of a (batch,
// kv head), 64 each consumer warpgroup; warp 0 of the producer loads the
// rows once and a ring of 64-key K/V tiles; each warpgroup recomputes S
// and dP for its rows and keeps dQ += dS K in registers, written once.
// Then bwd_ws<..., false> computes dK and dV: seven products' worth of
// work for the gradient's five, but no ordered adds.
constexpr int kDqRows = 128, kDqKeys = 64;

template <int HD, int HDV>
struct DqSmem {
  static constexpr size_t q = 0;                                     // Q [128][HD]
  static constexpr size_t dout = q + (size_t)kDqRows * HD * 2;       // dO [128][HDV]
  static constexpr size_t stage = dout + (size_t)kDqRows * HDV * 2;  // [kStages][K [64][HD], V [64][HDV]]
  static constexpr size_t stage_bytes = (size_t)kDqKeys * (HD + HDV) * 2;
  static constexpr size_t stats = stage + kStages * stage_bytes;     // lse2 [128], D [128]
  static constexpr size_t bars = stats + (size_t)kDqRows * 8;        // rows, full, empty
  static constexpr size_t total = bars + 8 * (1 + 2 * kStages) + 1024;
};

// S = Q K^T and dP = dO V^T for bwd_dq_ws: the warpgroup's 64 rows (rows
// 64 wg of the block's Q tile at qs, dO after it) against the staged K/V
// tile at ks (64 keys; V after K); one commit group each
template <int HD, int HDV>
__device__ __forceinline__ void dq_scores(float (&s)[kDqKeys / 8][4],
                                          float (&dp)[kDqKeys / 8][4], uint32_t qs, uint32_t ks,
                                          int wg) {
  constexpr int KT = kDqKeys;
  const uint32_t dos = qs + kDqRows * HD * 2, vs = ks + KT * HD * 2;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    wgmma_ss<KT>(s, desc_k_major<HD, kDqRows>(qs, kc, wg * 64), desc_k_major<HD, KT>(ks, kc, 0),
                 kc);
  wgmma_commit();
#pragma unroll
  for (int dc = 0; dc < HDV / 16; ++dc)
    wgmma_ss<KT>(dp, desc_k_major<HDV, kDqRows>(dos, dc, wg * 64),
                 desc_k_major<HDV, KT>(vs, dc, 0), dc);
  wgmma_commit();
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreadsWs, 1)
    bwd_dq_ws(const __grid_constant__ WsArgs a, const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_do, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v) {
  using L = DqSmem<HD, HDV>;
  constexpr int RB = kDqRows, KT = kDqKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  const uint32_t bar_rows = sb + (uint32_t)L::bars;
  auto bar_full = [&](int s) { return bar_rows + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_rows + 8 * (1 + kStages + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_rows, a.tma_rows ? 1 : 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int nbh = a.B * a.hk, g = a.h / a.hk, rows = g * a.S;
  const int n_rb = (rows + RB - 1) / RB;
  const int bh = blockIdx.x % nbh, r0 = (n_rb - 1 - (int)(blockIdx.x / nbh)) * RB;
  const int b = bh / a.hk, kvh = bh % a.hk;
  int k_lo, k_hi;
  keys_seen(a, g, r0, min(r0 + RB, rows), k_lo, k_hi);
  const int t_first = k_lo / KT, n_tiles = k_hi > k_lo ? (k_hi - 1) / KT + 1 - t_first : 0;

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    setmaxnreg_dec<kProducerRegs>();
    const int lane = tid & 31;
    if (tid >= 32) return;
    const uint32_t qs = sb + L::q, dos = sb + L::dout, stats = sb + L::stats;
    const size_t srow = (size_t)bh * a.rpad + r0;
    if (a.tma_rows) {
      if (lane == 0) {
        mbar_expect_tx(bar_rows, RB * (HD + HDV) * 2 + RB * 8);
        for (int hf = 0; hf < 2; ++hf) {
          for (int c = 0; c < HD / 64; ++c)
            tma_load_4d(qs + c * RB * 128 + hf * 64 * 128, &tm_q, bar_rows, c * 64, kvh * g,
                        (r0 + 64 * hf) / g, b);
          for (int c = 0; c < HDV / 64; ++c)
            tma_load_4d(dos + c * RB * 128 + hf * 64 * 128, &tm_do, bar_rows, c * 64, kvh * g,
                        (r0 + 64 * hf) / g, b);
        }
        bulk_load(stats, a.lse2 + srow, RB * 4, bar_rows);
        bulk_load(stats + RB * 4, a.dsum + srow, RB * 4, bar_rows);
      }
    } else {
      for (int j = lane; j < RB * (HD / 8); j += 32) {
        const int r = j / (HD / 8), ch = j % (HD / 8);
        const bool ok = r0 + r < rows;
        cp_async16(qs + swz<HD, RB>(r, ch),
                   ok ? a.q + row_off(b, r0 + r, g, kvh, a.S, a.h, HD) + ch * 8 : a.q, ok);
      }
      for (int j = lane; j < RB * (HDV / 8); j += 32) {
        const int r = j / (HDV / 8), ch = j % (HDV / 8);
        const bool ok = r0 + r < rows;
        cp_async16(dos + swz<HDV, RB>(r, ch),
                   ok ? a.dout + row_off(b, r0 + r, g, kvh, a.S, a.h, HDV) + ch * 8 : a.dout, ok);
      }
      for (int j = lane; j < RB / 2; j += 32) {
        const int half = j / (RB / 4), ch = j % (RB / 4);
        cp_async16(stats + half * RB * 4 + ch * 16, (half ? a.dsum : a.lse2) + srow + ch * 4,
                   true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(bar_rows);
    }
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, t0 = (t_first + i) * KT;
        const uint32_t ks = sb + L::stage + st * L::stage_bytes, vs = ks + KT * HD * 2;
        mbar_wait(bar_empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(st), KT * (HD + HDV) * 2);
        for (int c = 0; c < HD / 64; ++c)
          tma_load_4d(ks + c * KT * 128, &tm_k, bar_full(st), c * 64, kvh, t0, b);
        for (int c = 0; c < HDV / 64; ++c)
          tma_load_4d(vs + c * KT * 128, &tm_v, bar_full(st), c * 64, kvh, t0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = role - 1, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int off = a.T - a.S;
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t qs = sb + L::q;
  const float* lse_s = reinterpret_cast<const float*>(base + L::stats);
  const float* d_s = lse_s + RB;
  const int wr0 = r0 + wg * 64 + warp * 16, wr1 = min(wr0 + 16, rows);   // the warp's rows
  float lse2[2], dsum[2];
  int qp[2];
  mbar_wait(bar_rows, 0);
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int rl = wg * 64 + warp * 16 + (lane >> 2) + 8 * e2;
    lse2[e2] = lse_s[rl];
    dsum[e2] = d_s[rl];
    qp[e2] = (r0 + rl) / g + off;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[kDqKeys / 8][4], dp[kDqKeys / 8][4];
  // tile i + 1's S and dP are issued before tile i's dQ product finishes
  if (n_tiles > 0) {
    mbar_wait(bar_full(0), 0);
    dq_scores<HD, HDV>(s, dp, qs, sb + L::stage, wg);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, t0 = (t_first + i) * KT;
    const uint32_t ks = sb + L::stage + st * L::stage_bytes;
    wgmma_wait<1>();   // S
    const bool tile_full = unit_state(a, g, wr0, wr1, t0, min(t0 + KT, a.T)) == 1 &&
                           t0 + KT <= a.T;
#pragma unroll
    for (int u = 0; u < KT / kUnit; ++u) {
      const int k0 = t0 + u * kUnit;
      const bool full = tile_full || (unit_state(a, g, wr0, wr1, k0, min(k0 + kUnit, a.T)) == 1 &&
                                      k0 + kUnit <= a.T);
#pragma unroll
      for (int nt = 2 * u; nt < 2 * u + 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale_log2 - lse2[e >> 1];
          if (!full) {
            const int kp = t0 + nt * 8 + (lane & 3) * 2 + (e & 1);
            x = visible(a, kp, qp[e >> 1]) ? x : -INFINITY;
          }
          s[nt][e] = fast_exp2(x);
        }
      }
    }
    wgmma_wait<0>();   // dP
    uint32_t af[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dsum[e >> 1]);
      pack_a(af[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) rs_product<HD, KT>(acc, af[kk], ks, kk);
    wgmma_commit();
    if (i + 1 < n_tiles) {
      mbar_wait(bar_full((i + 1) % kStages), ((i + 1) / kStages) & 1);
      dq_scores<HD, HDV>(s, dp, qs, sb + L::stage + ((i + 1) % kStages) * L::stage_bytes, wg);
      wgmma_wait<2>();   // dQ += dS K: the stage is read
    } else {
      wgmma_wait<0>();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(st));
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = wr0 + (lane >> 2) + 8 * e2;
    if (r >= rows) continue;
    bf16* dst = a.dq + row_off(b, r, g, kvh, a.S, a.h, HD) + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * e2] * a.scale, acc[n][2 * e2 + 1] * a.scale);
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
  int rc = set_smem(bwd_ws<HD, HDV, ordered_dq(HD)>, WsSmem<HD, HDV>::total);
  if (!ordered_dq(HD) && !rc) rc = set_smem(bwd_dq_ws<HD, HDV>, DqSmem<HD, HDV>::total);
  if (!rc) rc = set_smem(dq_f32<HD, HDV>, dq_f32_smem(HD, HDV));
  if (!rc) rc = set_smem(dkdv_f32<HD, HDV>, dkdv_f32_smem(HD, HDV));
  return rc;
}

template <int HD, int HDV>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int g = a.h / a.hk;
  const dim3 grid_dq(a.B * a.hk, (g * a.S + kF32Rows - 1) / kF32Rows);
  const dim3 grid_kv(a.B * a.hk, (a.T + kF32Keys - 1) / kF32Keys);
  if (grid_dq.y > 65535 || grid_kv.y > 65535) return (int)cudaErrorInvalidConfiguration;
  dq_f32<HD, HDV><<<grid_dq, kThreadsF32, dq_f32_smem(HD, HDV), stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // after the dq kernel on the same stream: it wrote D
  dkdv_f32<HD, HDV><<<grid_kv, kThreadsF32, dkdv_f32_smem(HD, HDV), stream>>>(a);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1, which the process has
// loaded (this library links against the CUDA runtime alone)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a 4-d bf16 tensor map (dims innermost first; byte strides of dims 1..3)
// read in boxes of 64 x b1 x b2 x 1 into the 128-byte swizzle (sm90::swz)
bool map_4d(CUtensorMap* m, const void* p, uint64_t d0, uint64_t d1, uint64_t d2, uint64_t d3,
            uint64_t s1, uint64_t s2, uint64_t s3, uint32_t b1, uint32_t b2) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3}, strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {64, b1, b2, 1}, unit[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HDV>
int launch_bf16(WsArgs a, cudaStream_t stream) {
  constexpr int QT = row_tile(HD);
  const int g = a.h / a.hk;
  a.n_rt = (g * a.S + QT - 1) / QT;
  a.rpad = (g * a.S + 127) / 128 * 128;
  const int n_kb = (a.T + kKeyBlock - 1) / kKeyBlock;
  a.tma_rows = QT % g == 0;
  CUtensorMap tm_q{}, tm_do{}, tm_k{}, tm_v{};
  const bool mapped =
      map_4d(&tm_k, a.k, HD, a.hk, a.T, a.B, HD * 2, a.k_ss * 2, a.k_bs * 2, 1, kKeyBlock) &&
      map_4d(&tm_v, a.v, HDV, a.hk, a.T, a.B, HDV * 2, a.v_ss * 2, a.v_bs * 2, 1, kKeyBlock) &&
      (!a.tma_rows ||
       (map_4d(&tm_q, a.q, HD, a.h, a.S, a.B, HD * 2, (uint64_t)a.h * HD * 2,
               (uint64_t)a.S * a.h * HD * 2, g, QT / g) &&
        map_4d(&tm_do, a.dout, HDV, a.h, a.S, a.B, HDV * 2, (uint64_t)a.h * HDV * 2,
               (uint64_t)a.S * a.h * HDV * 2, g, QT / g)));
  if (!mapped) return (int)cudaErrorNotSupported;
  const long long stat_rows = (long long)a.B * a.hk * a.rpad;
  bwd_rowstats<HD, HDV><<<(unsigned)((stat_rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (ordered_dq(HD)) {
    bwd_ws<HD, HDV, true><<<n_kb * a.B * a.hk, kThreadsWs, WsSmem<HD, HDV>::total, stream>>>(
        a, tm_q, tm_do, tm_k, tm_v);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (a.B * a.hk > 65535) return (int)cudaErrorInvalidConfiguration;
    bwd_dq_out<HD><<<dim3(a.n_rt, a.B * a.hk), 256, 0, stream>>>(a);
    return (int)cudaGetLastError();
  } else {
    // the dq kernel's own boxes: 64 keys a K/V tile, 64 rows a Q/dO box
    WsArgs ad = a;
    ad.tma_rows = 64 % g == 0;
    CUtensorMap tm_q64{}, tm_do64{}, tm_k64{}, tm_v64{};
    if (!map_4d(&tm_k64, a.k, HD, a.hk, a.T, a.B, HD * 2, a.k_ss * 2, a.k_bs * 2, 1, kDqKeys) ||
        !map_4d(&tm_v64, a.v, HDV, a.hk, a.T, a.B, HDV * 2, a.v_ss * 2, a.v_bs * 2, 1,
                kDqKeys) ||
        (ad.tma_rows &&
         (!map_4d(&tm_q64, a.q, HD, a.h, a.S, a.B, HD * 2, (uint64_t)a.h * HD * 2,
                  (uint64_t)a.S * a.h * HD * 2, g, 64 / g) ||
          !map_4d(&tm_do64, a.dout, HDV, a.h, a.S, a.B, HDV * 2, (uint64_t)a.h * HDV * 2,
                  (uint64_t)a.S * a.h * HDV * 2, g, 64 / g))))
      return (int)cudaErrorNotSupported;
    const int n_rb = a.rpad / kDqRows;
    bwd_dq_ws<HD, HDV><<<n_rb * a.B * a.hk, kThreadsWs, DqSmem<HD, HDV>::total, stream>>>(
        ad, tm_q64, tm_do64, tm_k64, tm_v64);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bwd_ws<HD, HDV, false><<<n_kb * a.B * a.hk, kThreadsWs, WsSmem<HD, HDV>::total, stream>>>(
        a, tm_q, tm_do, tm_k, tm_v);
    return (int)cudaGetLastError();
  }
}

bool widths_ok(int hd, int hdv) {
  return (hd == 64 && hdv == 64) || (hd == 128 && hdv == 128) || (hd == 192 && hdv == 128);
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
  if (B <= 0 || S <= 0 || Tk <= 0 || hk <= 0 || h % hk || !widths_ok(hd, hdv))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
               dq, dk, dv, B, S, Tk, h, hk, k_bs, k_ss, v_bs, v_ss, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_f32<64, 64>(a, st);
  if (hd == 128) return launch_f32<128, 128>(a, st);
  return launch_f32<192, 128>(a, st);
}

// Bytes of the zeroed workspace a bf16 call takes (its ticket and counters,
// the rows' statistics, the fp32 sums of dQ).
unsigned long long flash_attention_bwd_bf16_workspace(int B, int S, int h, int hk, int hd) {
  return workspace(B, S, h, hk, hd).bytes;
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                             const void* lse, const void* dout, void* work, void* dq, void* dk,
                             void* dv, int B, int S, int Tk, int h, int hk, int hd, int hdv,
                             long long k_bs, long long k_ss, long long v_bs, long long v_ss,
                             int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || hk <= 0 || h % hk || !widths_ok(hd, hdv))
    return (int)cudaErrorInvalidValue;
  const Workspace w = workspace(B, S, h, hk, hd);
  unsigned char* ws = static_cast<unsigned char*>(work);
  WsArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sem = reinterpret_cast<int*>(ws);
  a.lse2 = reinterpret_cast<float*>(ws + w.lse2);
  a.dsum = reinterpret_cast<float*>(ws + w.dsum);
  a.dq_acc = reinterpret_cast<float*>(ws + w.dq_acc);
  a.B = B, a.S = S, a.T = Tk, a.h = h, a.hk = hk;
  a.k_bs = k_bs, a.k_ss = k_ss, a.v_bs = v_bs, a.v_ss = v_ss;
  a.causal = causal, a.window = window, a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_bf16<64, 64>(a, st);
  if (hd == 128) return launch_bf16<128, 128>(a, st);
  return launch_bf16<192, 128>(a, st);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
