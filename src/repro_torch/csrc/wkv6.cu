// Chunked RWKV-6 WKV recurrence on Hopper (sm_90a); r/k/v/y in fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::wkv6_pallas (body
// _wkv6_kernel).  It computes what the chunked form computes (the plain
// PyTorch version, kernels/wkv6.py::wkv6_chunked):
//   r, k, v  (B, T, H, K)  T       receptance, key, value
//   w        (B, T, H, K)  fp32    log-decay, <= 0
//   u        (H, K)        fp32    bonus of the current token
//   s0       (B, H, K, K)  fp32    state carried in, (key, value)
//   y        (B, T, H, K)  T       output
//   sT       (B, H, K, K)  fp32    state after the last step
// per chunk of C <= 32 steps (all fp32):
//   L = cumsum_t w (inclusive), Lp = L - w (exclusive)
//   y[t]  = (r[t] * exp(Lp[t])) @ S                            carried state
//         + sum_{j<t} (sum_k r[t,k] k[j,k] exp(clip(Lp[t,k] - L[j,k], -60, 0))) v[j]
//         + (sum_k r[t,k] u[k] k[t,k]) v[t]                    bonus
//   S'    = exp(L[C-1]) * S + (k * exp(L[C-1] - L))^T @ v
// A ragged tail counts its missing rows as r = k = v = 0 and w = 0, which is
// what the reference's zero padding computes; nothing is padded in memory.
//
// Bound: memory.  A call must read r, k, v, w and s0 once and write y and sT
// once: at a 32-token prefill chunk (B = 1, H = 32, K = 64, bf16 r/k/v/y)
// about 1.84 MB, 0.55 us at 3.35 TB/s.  Its arithmetic (about 0.6 M
// exponentials and 30 MFLOP) is far under the card's rates, so a call of the
// serving path is bound by latency: how few dependent steps lie between its
// first load and its last store.
//
// Design.  The TPU kernel walks a (B*H, T/C) grid whose chunk axis runs in
// order and carries S in VMEM scratch; Hopper blocks run in no order, so:
//   * The K / 16 blocks of a head form a thread-block cluster; rank c owns
//     key channels [16c, 16c + 16): their cumsum, their decayed operands, the
//     score partial sums over them, and rows [16c, 16c + 16) of the state,
//     which it keeps in shared memory across the chunks of the call.  Every
//     term of y is a sum over key channels, so each rank computes a partial
//     y (C x K) over its channels alone; after cluster.sync() rank c adds the
//     ranks' partials of its 16 value columns, read through distributed
//     shared memory, in rank order (a call is bitwise repeatable).  The
//     state's rows need nothing from other ranks; the last chunk writes them
//     out from registers.  Nothing is computed twice.
//   * The cumsum adds a channel's steps in order on one lane, as the
//     reference's torch.cumsum does (32 dependent adds, ~0.1 us); a warp prefix
//     scan re-associates the sum, moves L by a few ulps of |L| ~ 50, and
//     exp turns that into 1e-5 relative errors: with it, the fp32 path used
//     up to 0.89 of the WKV bar against 0.05 for the in-order sum.  Every
//     exponent is a difference of log-decays taken first, as in the
//     reference, then scaled by log2(e) for ex2.approx.
//   * The clipped pairwise decay factors at a sub-chunk boundary.  With
//     16-row sub-chunks, for t in a sub-chunk after j's and L_ref = L at the
//     last row of j's sub-chunk, Lp[t] - L[j] = (Lp[t] - L_ref) + (L_ref -
//     L[j]) with both terms <= 0, so the block of such (t, j) is the product
//     (r * exp(Lp - L_ref)) (k * exp(L_ref - L))^T of two bounded operands;
//     it differs from the clipped form by at most e^-60 |r_t k_j| a term.
//     The diagonal blocks keep the clipped exponential per term (and the
//     bonus u on the diagonal), in fp32 FMAs.
//   * The products -- the off-diagonal score block, (r e^Lp) @ S, scores @ v
//     and (k e^{L_last - L})^T @ v -- run on mma.sync with split operands:
//     a = a_hi + a_lo, d += a_lo b_hi + a_hi b_lo + a_hi b_hi.  A single
//     bf16 or tf32 rounding of a decayed operand breaks the WKV bar; the
//     split keeps about 16 (bf16) or 21 (tf32) bits.  bf16 calls use bf16
//     m16n8k16, where v is exact and its low part is skipped; fp32 calls use
//     tf32 m16n8k8 ("3xTF32").
//   * r, k, w (this rank's channels) and v (all columns) of a chunk are
//     cp.async-copied in two groups, so v lands while the scores run, and the
//     next chunk's copies fly while this chunk is computed.
//   * 4 warps a block (8 measured slower); a 32-token chunk at
//     B 1, H 32, K 64 is 32 clusters of 4, 128 blocks.  The dynamic shared
//     memory (60 KB in bf16) is opted into once per kernel instantiation,
//     not per launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "scan_probe.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCT = 32;              // rows of a chunk tile (chunk <= 32)
constexpr int kSub = 16;             // rows of a sub-chunk
constexpr int kKC = 16;              // key channels (and y columns) of a rank
constexpr int kWarps = 4;            // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kTpr = kThreads / kCT; // threads a score row in the diagonal blocks
static_assert(kKC % kWarps == 0 && kSub % kTpr == 0, "warps share channels and rows evenly");
constexpr int kLdw = kKC + 4;        // row stride of the (kCT, kKC) fp32 arrays
constexpr int kLda = kCT + 1;        // row stride of the score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClip = -60.f;

// exp(x) on the special-function unit; x is a difference of log-decays
// taken first, as the reference takes it
__device__ __forceinline__ float exp_sfu(float x) { return sm90::fast_exp2(x * kLog2e); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---- split-operand products on mma.sync ------------------------------------
//
// frag_a / frag_b gather one k-step's fragments from accessors fa(row, col)
// and fb(row, col) (fp32 values) and split each value x into hi = round(x)
// and lo = round(x - hi) of the product type.  Accumulator layout (both):
// d[e] = (row lane / 4 + 8 (e / 2), col 2 (lane % 4) + e % 2).

struct Bf16Split {                   // bf16 m16n8k16
  static constexpr int kK = 16;
  __device__ static void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
  template <class FA>
  __device__ static void frag_a(const FA& fa, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    split(fa(g, 2 * q), fa(g, 2 * q + 1), hi[0], lo[0]);
    split(fa(g + 8, 2 * q), fa(g + 8, 2 * q + 1), hi[1], lo[1]);
    split(fa(g, 2 * q + 8), fa(g, 2 * q + 9), hi[2], lo[2]);
    split(fa(g + 8, 2 * q + 8), fa(g + 8, 2 * q + 9), hi[3], lo[3]);
  }
  template <class FB>
  __device__ static void frag_b(const FB& fb, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    split(fb(2 * q, g), fb(2 * q + 1, g), hi[0], lo[0]);
    split(fb(2 * q + 8, g), fb(2 * q + 9, g), hi[1], lo[1]);
  }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    sm90::mma_bf16(d, a, b[0], b[1]);
  }
};

struct Tf32Split {                   // tf32 m16n8k8
  static constexpr int kK = 8;
  __device__ static void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = sm90::to_tf32(x);
    lo = sm90::to_tf32(x - __uint_as_float(hi));
  }
  template <class FA>
  __device__ static void frag_a(const FA& fa, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    split(fa(g, q), hi[0], lo[0]);
    split(fa(g + 8, q), hi[1], lo[1]);
    split(fa(g, q + 4), hi[2], lo[2]);
    split(fa(g + 8, q + 4), hi[3], lo[3]);
  }
  template <class FB>
  __device__ static void frag_b(const FB& fb, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    split(fb(q, g), hi[0], lo[0]);
    split(fb(q + 4, g), hi[1], lo[1]);
  }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    sm90::mma_tf32(d, a, b[0], b[1]);
  }
};

// A's fragments for d (16 x 8) += A (16 x KD) B (KD x 8), A = fa(row, k),
// split once and kept in registers for every n-tile the warp multiplies.
template <class P, int KD>
struct AFrag {
  static constexpr int kSteps = KD / P::kK;
  uint32_t hi[kSteps][4], lo[kSteps][4];
  template <class FA>
  __device__ __forceinline__ void load(const FA& fa) {
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      P::frag_a([&](int r, int c) { return fa(r, st * P::kK + c); }, hi[st], lo[st]);
  }
};

// d += A B in three products of the split parts, B = fb(k, col); kExactB: B
// is exact in the product type (bf16 v of a bf16 call), so its low part is
// zero and that product skipped.
template <class P, int KD, bool kExactB, class FB>
__device__ __forceinline__ void mma_ab(float (&d)[4], const AFrag<P, KD>& a, const FB& fb) {
#pragma unroll
  for (int st = 0; st < AFrag<P, KD>::kSteps; ++st) {
    uint32_t bh[2], bl[2];
    P::frag_b([&](int r, int c) { return fb(st * P::kK + r, c); }, bh, bl);
    P::mma(d, a.lo[st], bh);
    if constexpr (!kExactB) P::mma(d, a.hi[st], bl);
    P::mma(d, a.hi[st], bh);
  }
}

// ---- shared memory ----------------------------------------------------------

template <typename T, int K>
struct Layout {
  static constexpr int kVld = K + 16 / (int)sizeof(T);  // v row: +16 B, no bank conflicts
  static constexpr int kLdv = K + 4;                    // fp32 rows of S and partial y
  // a stage: r, k (kCT x kKC of T), w (kCT x kKC fp32), v (kCT x kVld of T)
  static constexpr int kR = 0;
  static constexpr int kKo = kR + kCT * kKC * (int)sizeof(T);
  static constexpr int kW = kKo + kCT * kKC * (int)sizeof(T);
  static constexpr int kV = kW + kCT * kKC * 4;
  static constexpr int kStage = kV + kCT * kVld * (int)sizeof(T);
  static_assert(kStage % 16 == 0, "stages stay 16-byte aligned");
  // fp32 arrays after the two stages, in floats
  static constexpr int kS = 0;                          // (kKC, kLdv) state rows
  static constexpr int kY = kS + kKC * kLdv;            // (2, kCT, kLdv) partial y
  static constexpr int kA = kY + 2 * kCT * kLdv;        // (kCT, kLda) partial scores
  static constexpr int kRf = kA + kCT * kLda;           // (kCT, kLdw) each below
  static constexpr int kKf = kRf + kCT * kLdw;          // r, k as fp32
  static constexpr int kL = kKf + kCT * kLdw;           // L, inclusive natural-log decay
  static constexpr int kLp = kL + kCT * kLdw;           // Lp, exclusive
  static constexpr int kRd = kLp + kCT * kLdw;          // r e^Lp
  static constexpr int kKs = kRd + kCT * kLdw;          // k e^(L_last - L)
  static constexpr int kOf = kKs + kCT * kLdw;          // rows < 16: k e^(L_ref - L); else r e^(Lp - L_ref)
  static constexpr int kU = kOf + kCT * kLdw;           // (kKC) u
  static constexpr int kEl = kU + kKC;                  // (kKC) e^L_last
  static constexpr int kFloats = kEl + kKC;
  static constexpr size_t kBytes = 2 * (size_t)kStage + (size_t)kFloats * 4;
};

// ---- the kernel -------------------------------------------------------------
//
// Grid (K / 16, B * H), a cluster of K / 16 blocks along x: rank c of head
// (b, h).  P: Bf16Split for bf16 calls, Tf32Split for fp32.
template <typename T, class P, int K>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT,
            int T_len, int H, int C) {
  using Lay = Layout<T, K>;
  constexpr int NR = K / kKC;
  constexpr int kLdv = Lay::kLdv, kVld = Lay::kVld;
  constexpr bool kExactV = sizeof(T) == 2;   // bf16 v is exact in bf16 products
  extern __shared__ __align__(16) unsigned char smem[];
  float* fs = reinterpret_cast<float*>(smem + 2 * Lay::kStage);
  float* S_s = fs + Lay::kS;
  float* A_s = fs + Lay::kA;
  float* rf = fs + Lay::kRf;
  float* kf = fs + Lay::kKf;
  float* L_s = fs + Lay::kL;
  float* Lp_s = fs + Lay::kLp;
  float* rd_s = fs + Lay::kRd;
  float* ks_s = fs + Lay::kKs;
  float* of_s = fs + Lay::kOf;
  float* u_s = fs + Lay::kU;
  float* eL_s = fs + Lay::kEl;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int ch0 = rank * kKC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_stride = H * K;                       // elements between steps
  const size_t head_off = (size_t)b * T_len * row_stride + (size_t)h * K;
  const int n_chunks = (T_len + C - 1) / C;
  PROBE_START();

  // One chunk's copies: group 1 r, k, w of this rank's channels (with the
  // state rows and u for the first chunk); group 2 v, all columns.  Rows past
  // the chunk's end are zero-filled.
  auto stage = [&](int ci) {
    unsigned char* st = smem + (ci & 1) * Lay::kStage;
    const int t0 = ci * C, nvalid = min(C, T_len - t0);
    constexpr int RC = kKC * (int)sizeof(T) / 16;     // 16-byte chunks of an r / k row
    constexpr int WC = kKC * 4 / 16;
    constexpr int n1 = kCT * (2 * RC + WC);
    for (int i = tid; i < n1; i += kThreads) {
      int t, c, dst;
      const void* src;
      if (i < 2 * kCT * RC) {
        const int which = i / (kCT * RC), j = i % (kCT * RC);
        t = j / RC;
        c = j % RC;
        const T* base = which ? k : r;
        src = base + head_off + (size_t)(t0 + t) * row_stride + ch0 + c * (16 / sizeof(T));
        dst = (which ? Lay::kKo : Lay::kR) + (t * kKC) * (int)sizeof(T) + c * 16;
      } else {
        const int j = i - 2 * kCT * RC;
        t = j / WC;
        c = j % WC;
        src = w + head_off + (size_t)(t0 + t) * row_stride + ch0 + c * 4;
        dst = Lay::kW + t * kKC * 4 + c * 16;
      }
      const bool live = t < nvalid;
      sm90::cp_async16(sm90::smem_addr(st + dst), live ? src : (const void*)w, live);
    }
    if (ci == 0) {
      constexpr int SC = K / 4;                        // 16-byte chunks of a state row
      const float* s_in = s0 + ((size_t)bh * K + ch0) * K;
      for (int i = tid; i < kKC * SC + kKC / 4; i += kThreads) {
        if (i < kKC * SC) {
          const int rr = i / SC, c = i % SC;
          sm90::cp_async16(sm90::smem_addr(S_s + rr * kLdv + c * 4), s_in + rr * K + c * 4, true);
        } else {
          const int c = i - kKC * SC;
          sm90::cp_async16(sm90::smem_addr(u_s + c * 4), u + (size_t)h * K + ch0 + c * 4, true);
        }
      }
    }
    sm90::cp_async_commit();
    constexpr int VC = K * (int)sizeof(T) / 16;
    for (int i = tid; i < kCT * VC; i += kThreads) {
      const int t = i / VC, c = i % VC;
      const bool live = t < nvalid;
      const T* src = v + head_off + (size_t)(t0 + t) * row_stride + c * (16 / sizeof(T));
      sm90::cp_async16(sm90::smem_addr(st + Lay::kV + (t * kVld) * (int)sizeof(T) + c * 16),
                       live ? (const void*)src : (const void*)w, live);
    }
    sm90::cp_async_commit();
  };

  stage(0);

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    const int t0 = ci * C, nvalid = min(C, T_len - t0);
    const bool has_next = ci + 1 < n_chunks;
    const unsigned char* st = smem + buf * Lay::kStage;
    const T* r_st = reinterpret_cast<const T*>(st + Lay::kR);
    const T* k_st = reinterpret_cast<const T*>(st + Lay::kKo);
    const float* w_st = reinterpret_cast<const float*>(st + Lay::kW);
    const T* v_st = reinterpret_cast<const T*>(st + Lay::kV);
    sm90::cp_async_wait<1>();          // r, k, w of this chunk (v may still fly)
    __syncthreads();
    PROBE_MARK(0);
    if (has_next) stage(ci + 1);       // the other stage: read by chunk ci - 1, done

    // ---- cumsum over time, then the decayed operands ----
    // one lane a channel adds the steps in order, as torch.cumsum does: a
    // re-associated (tree) sum moves L by a few ulps of |L|, which exp turns
    // into relative errors of 1e-5 at the serving path's decays
    if (lane < kKC / kWarps) {
      const int ch = warp * (kKC / kWarps) + lane;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kCT; ++t) {
        const float wv = w_st[t * kKC + ch];
        acc += wv;
        L_s[t * kLdw + ch] = acc;
        Lp_s[t * kLdw + ch] = acc - wv;
      }
    }
    __syncwarp();
#pragma unroll
    for (int cc = 0; cc < kKC / kWarps; ++cc) {      // lane = step
      const int ch = warp * (kKC / kWarps) + cc, t = lane;
      const float rv = to_f32(r_st[t * kKC + ch]);
      const float kv = to_f32(k_st[t * kKC + ch]);
      const float L = L_s[t * kLdw + ch], Lp = Lp_s[t * kLdw + ch];
      const float Llast = L_s[(kCT - 1) * kLdw + ch];
      const float Lref = L_s[(kSub - 1) * kLdw + ch];
      rf[t * kLdw + ch] = rv;
      kf[t * kLdw + ch] = kv;
      rd_s[t * kLdw + ch] = rv * exp_sfu(Lp);
      ks_s[t * kLdw + ch] = kv * exp_sfu(Llast - L);
      of_s[t * kLdw + ch] = t < kSub ? kv * exp_sfu(Lref - L) : rv * exp_sfu(Lp - Lref);
      if (lane == 0) eL_s[ch] = exp_sfu(Llast);
    }
    __syncthreads();
    PROBE_MARK(1);

    // ---- partial scores over this rank's channels ----
    // the two diagonal blocks: clipped decay per term, the bonus on the
    // diagonal; a thread keeps row t in registers for its kSub / kTpr columns
    {
      const int t = (lane / kTpr) * kWarps + warp;     // rows spread over the warps
      const int tt = t % kSub, j0 = t - tt;
      float4 lp4[kKC / 4], r4[kKC / 4];
#pragma unroll
      for (int i = 0; i < kKC / 4; ++i) {
        lp4[i] = *reinterpret_cast<const float4*>(Lp_s + t * kLdw + 4 * i);
        r4[i] = *reinterpret_cast<const float4*>(rf + t * kLdw + 4 * i);
      }
#pragma unroll
      for (int n = 0; n < kSub / kTpr; ++n) {
        const int jj = lane % kTpr + kTpr * n, j = j0 + jj;
        float acc0 = 0.f, acc1 = 0.f;
        if (jj < tt) {
#pragma unroll
          for (int i = 0; i < kKC / 4; ++i) {
            const float4 l4 = *reinterpret_cast<const float4*>(L_s + j * kLdw + 4 * i);
            const float4 k4 = *reinterpret_cast<const float4*>(kf + j * kLdw + 4 * i);
            auto term = [](float lp, float l) { return exp_sfu(fminf(fmaxf(lp - l, kClip), 0.f)); };
            acc0 = fmaf(r4[i].x * k4.x, term(lp4[i].x, l4.x), acc0);
            acc1 = fmaf(r4[i].y * k4.y, term(lp4[i].y, l4.y), acc1);
            acc0 = fmaf(r4[i].z * k4.z, term(lp4[i].z, l4.z), acc0);
            acc1 = fmaf(r4[i].w * k4.w, term(lp4[i].w, l4.w), acc1);
          }
        } else if (jj == tt) {
#pragma unroll
          for (int i = 0; i < kKC / 4; ++i) {
            const float4 u4 = *reinterpret_cast<const float4*>(u_s + 4 * i);
            const float4 k4 = *reinterpret_cast<const float4*>(kf + t * kLdw + 4 * i);
            acc0 = fmaf(r4[i].x * u4.x, k4.x, acc0);
            acc1 = fmaf(r4[i].y * u4.y, k4.y, acc1);
            acc0 = fmaf(r4[i].z * u4.z, k4.z, acc0);
            acc1 = fmaf(r4[i].w * u4.w, k4.w, acc1);
          }
        }
        A_s[t * kLda + j] = acc0 + acc1;
      }
    }
    // the block below them: (r e^(Lp - L_ref)) (k e^(L_ref - L))^T, one n-tile a warp
    if (warp < kSub / 8) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      AFrag<P, kKC> a;
      a.load([&](int rr, int c) { return of_s[(kSub + rr) * kLdw + c]; });
      mma_ab<P, kKC, false>(d, a, [&](int c, int n) { return of_s[(warp * 8 + n) * kLdw + c]; });
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        A_s[(kSub + g + 8 * (e >> 1)) * kLda + warp * 8 + 2 * q + (e & 1)] = d[e];
    }
    if (has_next) sm90::cp_async_wait<2>();   // this chunk's v
    else sm90::cp_async_wait<0>();
    __syncthreads();
    PROBE_MARK(2);

    // ---- partial y = (r e^Lp) @ S_rows + scores @ v;
    //      S_rows' = e^L_last S_rows + (k e^(L_last - L))^T @ v ----
    if (warp < K / 8) {
      constexpr int NTW = (K / 8 + kWarps - 1) / kWarps;   // n-tiles of 8 columns a warp
      float* yp = fs + Lay::kY + buf * kCT * kLdv;
      const int g = lane >> 2, q = lane & 3;
      AFrag<P, kKC> a_rd0, a_rd1;
      AFrag<P, kSub> a_sc0;              // rows 0-15: their scores past column 15 are 0
      AFrag<P, kCT> a_sc1, a_ks;
      a_rd0.load([&](int rr, int c) { return rd_s[rr * kLdw + c]; });
      a_rd1.load([&](int rr, int c) { return rd_s[(kSub + rr) * kLdw + c]; });
      a_sc0.load([&](int rr, int c) { return A_s[rr * kLda + c]; });
      a_sc1.load([&](int rr, int c) { return A_s[(kSub + rr) * kLda + c]; });
      a_ks.load([&](int ch, int t) { return ks_s[t * kLdw + ch]; });
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int nt = warp + kWarps * i;
        if (nt >= K / 8) break;
        const int n0 = nt * 8;
        auto fS = [&](int c, int n) { return S_s[c * kLdv + n0 + n]; };
        auto fv = [&](int t, int n) { return to_f32(v_st[t * kVld + n0 + n]); };
        float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f}, sn[4];
        mma_ab<P, kKC, false>(y0, a_rd0, fS);
        mma_ab<P, kKC, false>(y1, a_rd1, fS);
        mma_ab<P, kSub, kExactV>(y0, a_sc0, fv);
        mma_ab<P, kCT, kExactV>(y1, a_sc1, fv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = g + 8 * (e >> 1);
          sn[e] = eL_s[ch] * S_s[ch * kLdv + n0 + 2 * q + (e & 1)];
        }
        mma_ab<P, kCT, kExactV>(sn, a_ks, fv);
        __syncwarp();                  // the warp's reads of these S columns are done
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = g + 8 * (e >> 1), c = n0 + 2 * q + (e & 1);
          yp[rr * kLdv + c] = y0[e];
          yp[(kSub + rr) * kLdv + c] = y1[e];
          S_s[rr * kLdv + c] = sn[e];
        }
        if (!has_next) {               // the state rows out, from registers
          float* s_out = sT + ((size_t)bh * K + ch0) * K + n0 + 2 * q;
          *reinterpret_cast<float2*>(s_out + g * K) = make_float2(sn[0], sn[1]);
          *reinterpret_cast<float2*>(s_out + (g + 8) * K) = make_float2(sn[2], sn[3]);
        }
      }
    }
    PROBE_MARK(3);
    cluster.sync();                    // every rank's partial y is written
    PROBE_MARK(4);

    // ---- y of this rank's columns: the ranks' partials summed in rank order ----
    {
      const int rr = tid >> 2, c4 = (tid & 3) * 4;
      if (rr < nvalid) {
        const float* src = fs + Lay::kY + buf * kCT * kLdv + rr * kLdv + ch0 + c4;
        float4 part[NR];
#pragma unroll
        for (int p = 0; p < NR; ++p)   // every load issued before any is used
          part[p] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, p));
        float4 o = part[0];
#pragma unroll
        for (int p = 1; p < NR; ++p) {
          o.x += part[p].x; o.y += part[p].y; o.z += part[p].z; o.w += part[p].w;
        }
        T* dst = y + head_off + (size_t)(t0 + rr) * row_stride + ch0 + c4;
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(sm90::pack_bf16(o.x, o.y), sm90::pack_bf16(o.z, o.w));
        } else {
          *reinterpret_cast<float4*>(dst) = o;
        }
      }
    }
    PROBE_MARK(5);
  }

  cluster.sync();                      // peers are done reading this block
  PROBE_MARK(6);
  PROBE_END(blockIdx.y * gridDim.x + blockIdx.x);
}

template <typename T, class P, int K>
int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* y, void* sT, int B, int T_len, int H, int C,
             cudaStream_t stream) {
  constexpr size_t smem = Layout<T, K>::kBytes;
  static_assert(smem <= 227 * 1024, "fits one block's shared memory");
  static bool smem_set = false;        // once per instantiation, not per launch
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, P, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K / kKC, B * H);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K / kKC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, wkv6_kernel<T, P, K>, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(sT), T_len, H, C);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, class P>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* sT, int B, int T_len, int H, int K, int C,
           void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || C <= 0 || C > kCT || C > T_len || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {                         // clusters of 1 to 8 ranks
    case 16: return launch_k<T, P, 16>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    case 32: return launch_k<T, P, 32>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    case 48: return launch_k<T, P, 48>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    case 64: return launch_k<T, P, 64>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    case 80: return launch_k<T, P, 80>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    case 96: return launch_k<T, P, 96>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    case 112: return launch_k<T, P, 112>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    case 128: return launch_k<T, P, 128>(r, k, v, w, u, s0, y, sT, B, T_len, H, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

PROBE_EXPORT(wkv6)

extern "C" {

// chunk <= 32; K a multiple of 16 up to 128; operands contiguous, 16-byte aligned
int wkv6_f32(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* y, void* sT, int B, int T, int H, int K, int chunk,
             void* stream) {
  return launch<float, Tf32Split>(r, k, v, w, u, s0, y, sT, B, T, H, K, chunk, stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* w, const void* u,
              const void* s0, void* y, void* sT, int B, int T, int H, int K, int chunk,
              void* stream) {
  return launch<__nv_bfloat16, Bf16Split>(r, k, v, w, u, s0, y, sT, B, T, H, K, chunk,
                                          stream);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
