// Backward of the chunked RWKV-6 WKV recurrence on Hopper (sm_90a); r, k, v,
// dy and dr, dk, dv in fp32 or bf16, everything else fp32.
//
// No TPU kernel had a backward: the reference trains through its chunked XLA
// form with each chunk under jax.checkpoint (repro/kernels/ops.py,
// wkv6_chunked).  This is the backward of the port's WKV6 autograd Function,
// whose forward is csrc/wkv6.cu; it computes the gradient of that chunk scan,
// which kernels/wkv6.py::wkv6_chunked_bwd computes in plain PyTorch and
// wkv6_bwd_tiled follows chunk for chunk.  Per chunk of C <= 32 steps, with
// S its incoming state, G the cotangent of its outgoing state (dsT for the
// last chunk), L, Lp, Ll the inclusive, exclusive and last log-decays, and
// W[t,j] = exp(clip(Lp[t] - L[j], -60, 0)) (j < t):
//   dA[t,j] = dy[t] . v[j]  (j <= t; dA[t,t] is the bonus's)
//   dv[j]   = sum_{t>=j} A[t,j] dy[t] + (k[j] e^(Ll - L[j])) G,
//             A[t,j] = sum_k r[t] k[j] W[t,j] (j < t), A[t,t] = sum_k r[t] u k[t]
//   dr[t]   = e^Lp[t] (S dy[t]) + sum_{j<t} dA[t,j] k[j] W[t,j] + dA[t,t] u k[t]
//   dk[j]   = sum_{t>j} dA[t,j] r[t] W[t,j] + e^(Ll - L[j]) (G v[j]) + dA[j,j] u r[j]
//   du     += sum_t dA[t,t] r[t] k[t]
//   dw[i]   = dLl + sum_{t>=i} dL[t] + sum_{t>i} dLp[t], where
//             dLp[t] = r[t] (dr[t] - bonus), dL[j] = -k[j] (dk[j] - bonus),
//             dLl = e^Ll (S . G) + sum_j k[j] e^(Ll - L[j]) (G v[j])
//   G      <- e^Ll G + (r e^Lp)^T dy            (the incoming state's cotangent)
// (the clip has a zero gradient where it clips; taking W's gradient there
// instead moves a term by at most e^-60 |r k|, as the forward's factorisation
// does).
//
// Bound: memory, then the fp32 rate.  A call reads r, k, v, dy (compute
// dtype), w, u, the state and its cotangent (fp32) once and writes dr, dk, dv
// (compute dtype), dw, du and dstate0 (fp32) once: at rwkv6-1.6b's training
// call (B 1, T 4096, H 32, K 64, bf16) about 185 MB, 0.055 ms at 3.35 TB/s;
// its ~10 GFLOP take ~0.15 ms at 67 TFLOP/s.
//
// Design (right and deterministic first; tensor cores are later work):
//   * The forward's layout: the K / 16 blocks of a head form a cluster, rank c
//     owning key channels [16c, 16c + 16) and those rows of S and G; every
//     per-channel gradient (dr, dk, dw, du) is local to a rank.
//   * Pass 1 runs the state recurrence alone (S' = e^Ll S + (k e^(Ll - L))^T v)
//     and stores each chunk's incoming state rows to a scratch buffer
//     ((T / C) x B H x K x K fp32: 67 MB at the training call).
//   * Pass 2 walks the chunks in reverse.  dA sums over value columns and
//     dv over key channels, so each rank computes its partial of each over its
//     own 16 columns / channels (the partial dv with its partial A, bonus on
//     the diagonal, and its rows of G), and after cluster.sync() reads the
//     ranks' partials through distributed shared memory and adds them in rank
//     order, as the forward adds its partial y.  du sums over the batch: each
//     head writes its partial and a second kernel adds them in batch order.  No
//     atomics: two calls are bitwise equal.
//   * Every product is an fp32 FMA: no operand is rounded, so the WKV bar
//     needs none of the forward's split operands.  Shared memory, not the
//     FMA units, bounds the loops, so the product loops read float4 rows and
//     broadcast operands (a thread 4 rows of a column, or a row's dot in
//     float4 steps), and the next chunk's operands are loaded into registers
//     while this one is computed.
//   * The cumsum runs in order on one lane a channel, as in the forward (exp
//     magnifies a re-associated L); dw's suffix sums and the dot products of
//     dLl and du are warp shuffles, a warp a channel, a lane a step.
//   * 8 warps a block and two blocks an SM: at 16 warps and one block an SM
//     the 32 clusters of the training call did not all fit at once and ran in
//     two waves.  csrc/scan_probe.cuh's stamps split a call by phase
//     (launch/probe_scans.py).

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
constexpr int kKC = 16;              // key channels (and dv columns) of a rank
constexpr int kThreads = 256;        // 8 warps, two blocks an SM
constexpr int kWarps = kThreads / 32;
static_assert(kKC % kWarps == 0, "the warps share the channels in step (f)");
constexpr int kLdc = kKC + 1;        // row stride of the (kCT, kKC) arrays read by lane j
constexpr int kLda = kCT + 1;        // row stride of the (kCT, kCT) arrays
constexpr int kLdA = kCT + 4;        // ... read as float4 (partial A)
constexpr int kRed = 256;            // threads of the du reduction
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClip = -60.f;

__device__ __forceinline__ float exp_sfu(float x) { return sm90::fast_exp2(x * kLog2e); }
__device__ __forceinline__ float wexp(float lp, float l) {
  return exp_sfu(fminf(fmaxf(lp - l, kClip), 0.f));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// shared memory, in floats; the arrays read as float4 first (16-byte rows)
template <int K>
struct Layout {
  static constexpr int kLdv = K + 4;                   // rows of v, dy, S, G, partial dv
  static constexpr int kV = 0;                         // (kCT, kLdv) v, dy
  static constexpr int kDy = kV + kCT * kLdv;
  static constexpr int kS = kDy + kCT * kLdv;          // (kKC, kLdv) S rows, G rows
  static constexpr int kG = kS + kKC * kLdv;
  static constexpr int kXP = kG + kKC * kLdv;          // exchanged: partial dv, 2 buffers
  static constexpr int kRd = kXP + 2 * kCT * kLdv;     // (kCT, kKC) r e^Lp, k e^(Ll - L)
  static constexpr int kKs = kRd + kCT * kKC;
  static constexpr int kKsT = kKs + kCT * kKC;         // (kKC, kCT) k e^(Ll - L), transposed
  static constexpr int kA = kKsT + kKC * kCT;          // (kCT, kLdA) partial A
  static constexpr int kR = kA + kCT * kLdA;           // (kCT, kLdc) each: r, k,
  static constexpr int kK = kR + kCT * kLdc;
  static constexpr int kL = kK + kCT * kLdc;           //   L, Lp,
  static constexpr int kLp = kL + kCT * kLdc;
  static constexpr int kEk = kLp + kCT * kLdc;         //   e^(Ll - L),
  static constexpr int kDLp = kEk + kCT * kLdc;        //   dLp, dL, k dk_state
  static constexpr int kDL = kDLp + kCT * kLdc;
  static constexpr int kKdk = kDL + kCT * kLdc;
  static constexpr int kDA = kKdk + kCT * kLdc;        // (kCT, kLda) full dA
  static constexpr int kXdA = kDA + kCT * kLda;        // exchanged: partial dA, 2 buffers
  static constexpr int kU = kXdA + 2 * kCT * kLda;     // (kKC) u, e^Ll
  static constexpr int kEl = kU + kKC;
  static constexpr int kFloats = kEl + kKC;
  static constexpr size_t kBytes = (size_t)kFloats * 4;
  static_assert(kLdv % 4 == 0 && kRd % 4 == 0 && kA % 4 == 0, "float4 rows");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void fma4(float (&acc)[4], float4 a, float b) {
  acc[0] = fmaf(a.x, b, acc[0]);
  acc[1] = fmaf(a.y, b, acc[1]);
  acc[2] = fmaf(a.z, b, acc[2]);
  acc[3] = fmaf(a.w, b, acc[3]);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Grid (K / 16, B * H), a cluster of K / 16 blocks along x: rank c of head
// (b, h).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, const T* __restrict__ dy,
                const float* __restrict__ dsT, float* __restrict__ states,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, int T_len, int H, int C) {
  using Lay = Layout<K>;
  constexpr int NR = K / kKC, kLdv = Lay::kLdv;
  constexpr int NC = (kCT * kKC + kThreads - 1) / kThreads;   // prefetched r, k, w a thread
  constexpr int NV = (kCT * K + kThreads - 1) / kThreads;     // v, dy
  constexpr int NS = (kKC * K + kThreads - 1) / kThreads;     // state rows
  extern __shared__ __align__(16) float fs[];
  float* v_s = fs + Lay::kV;
  float* dy_s = fs + Lay::kDy;
  float* S_s = fs + Lay::kS;
  float* G_s = fs + Lay::kG;
  float* rd_s = fs + Lay::kRd;
  float* ks_s = fs + Lay::kKs;
  float* ksT_s = fs + Lay::kKsT;
  float* A_s = fs + Lay::kA;
  float* r_s = fs + Lay::kR;
  float* k_s = fs + Lay::kK;
  float* L_s = fs + Lay::kL;
  float* Lp_s = fs + Lay::kLp;
  float* ek_s = fs + Lay::kEk;
  float* dLp_s = fs + Lay::kDLp;
  float* dL_s = fs + Lay::kDL;
  float* kdk_s = fs + Lay::kKdk;
  float* dA_s = fs + Lay::kDA;
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
  const size_t chunk_states = (size_t)gridDim.y * K * K;   // a chunk's states, all heads
  float* my_rows = states + ((size_t)bh * K + ch0) * K;    // + ci * chunk_states
  PROBE_START();

  // The next chunk's operands are loaded into registers while this one is
  // computed (fetch), then stored to shared memory as fp32 (put): this
  // rank's r, k, w channels, all of v (and dy), and in pass 2 its state
  // rows.  Rows past the chunk's end are 0; w goes to L_s, summed in place.
  float kr[NC], wr[NC], rr_[NC], vr[NV], dyr[NV], sr[NS];
  auto fetch = [&](int ci, bool backward) {
    const int t0 = ci * C, nvalid = min(C, T_len - t0);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int i = tid + n * kThreads, t = i / kKC, c = i % kKC;
      const bool ok = i < kCT * kKC && t < nvalid;
      const size_t off = head_off + (size_t)(t0 + t) * row_stride + ch0 + c;
      kr[n] = ok ? to_f32(k[off]) : 0.f;
      wr[n] = ok ? w[off] : 0.f;
      rr_[n] = ok && backward ? to_f32(r[off]) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int i = tid + n * kThreads, t = i / K, c = i % K;
      const bool ok = i < kCT * K && t < nvalid;
      const size_t off = head_off + (size_t)(t0 + t) * row_stride + c;
      vr[n] = ok ? to_f32(v[off]) : 0.f;
      dyr[n] = ok && backward ? to_f32(dy[off]) : 0.f;
    }
    if (backward) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int i = tid + n * kThreads;
        sr[n] = i < kKC * K ? my_rows[ci * chunk_states + i] : 0.f;
      }
    }
  };
  auto put = [&](bool backward) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int i = tid + n * kThreads, t = i / kKC, c = i % kKC;
      if (i >= kCT * kKC) break;
      k_s[t * kLdc + c] = kr[n];
      L_s[t * kLdc + c] = wr[n];
      if (backward) r_s[t * kLdc + c] = rr_[n];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int i = tid + n * kThreads, t = i / K, c = i % K;
      if (i >= kCT * K) break;
      v_s[t * kLdv + c] = vr[n];
      if (backward) dy_s[t * kLdv + c] = dyr[n];
    }
    if (backward) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int i = tid + n * kThreads;
        if (i < kKC * K) S_s[(i / K) * kLdv + i % K] = sr[n];
      }
    }
  };
  // the cumsum, one lane a channel in order (as torch.cumsum and the forward
  // add: a re-associated sum moves L by ulps that exp magnifies), then e^Ll
  // and the decayed operands
  auto operands = [&](bool backward) {
    if (tid < kKC) {
      float acc = 0.f;
      for (int t = 0; t < kCT; ++t) {
        const float wv = L_s[t * kLdc + tid];
        acc += wv;
        L_s[t * kLdc + tid] = acc;
        Lp_s[t * kLdc + tid] = acc - wv;
      }
      eL_s[tid] = exp_sfu(acc);
    }
    __syncthreads();
    for (int i = tid; i < kCT * kKC; i += kThreads) {
      const int t = i / kKC, c = i % kKC;
      const float ek = exp_sfu(L_s[(kCT - 1) * kLdc + c] - L_s[t * kLdc + c]);
      const float ks = k_s[t * kLdc + c] * ek;
      ks_s[t * kKC + c] = ks;
      if (backward) {
        ek_s[t * kLdc + c] = ek;
        ksT_s[c * kCT + t] = ks;
        rd_s[t * kKC + c] = r_s[t * kLdc + c] * exp_sfu(Lp_s[t * kLdc + c]);
      }
    }
  };
  // X[c][x] <- e^Ll[c] X[c][x] + sum_t P[t][c] Q[t][x] over this rank's rows:
  // a thread 4 rows of one column, P's 4 entries a step one broadcast float4
  auto row_update = [&](float* X, const float* P, const float* Q) {
    for (int i = tid; i < (kKC / 4) * K; i += kThreads) {
      const int c0 = 4 * (i / K), x = i % K;
      float acc[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = eL_s[c0 + m] * X[(c0 + m) * kLdv + x];
#pragma unroll 4
      for (int t = 0; t < kCT; ++t) fma4(acc, ld4(P + t * kKC + c0), Q[t * kLdv + x]);
#pragma unroll
      for (int m = 0; m < 4; ++m) X[(c0 + m) * kLdv + x] = acc[m];
    }
  };

  // ---- pass 1: each chunk's incoming state rows ----
  for (int i = tid; i < kKC * K; i += kThreads) {
    const int rr = i / K, c = i % K;
    S_s[rr * kLdv + c] = s0[((size_t)bh * K + ch0 + rr) * K + c];
    G_s[rr * kLdv + c] = dsT != nullptr ? dsT[((size_t)bh * K + ch0 + rr) * K + c] : 0.f;
  }
  if (tid < kKC) u_s[tid] = u[(size_t)h * K + ch0 + tid];
  if (n_chunks > 1) fetch(0, false);
  for (int ci = 0; ci < n_chunks; ++ci) {
    __syncthreads();                   // S_s is final; the last chunk's reads are done
    for (int i = tid; i < kKC * K; i += kThreads)
      my_rows[ci * chunk_states + i] = S_s[(i / K) * kLdv + i % K];
    if (ci + 1 == n_chunks) break;
    put(false);
    if (ci + 2 < n_chunks) fetch(ci + 1, false);
    __syncthreads();
    operands(false);
    __syncthreads();
    row_update(S_s, ks_s, v_s);        // S' = e^Ll S + (k e^(Ll - L))^T v
  }
  __syncthreads();                     // the stored rows are visible to the block
  fetch(n_chunks - 1, true);
  PROBE_MARK(0);

  // ---- pass 2: the chunks in reverse ----
  float du_acc[kKC / kWarps] = {};     // lane 0: du of channels warp, warp + kWarps, ..
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * C, nvalid = min(C, T_len - t0);
    float* xdA = fs + Lay::kXdA + (ci & 1) * kCT * kLda;   // exchanged this chunk
    float* xP = fs + Lay::kXP + (ci & 1) * kCT * kLdv;
    __syncthreads();                   // the previous chunk's reads are done
    put(true);
    if (ci > 0) fetch(ci - 1, true);
    __syncthreads();
    PROBE_MARK(1);
    operands(true);
    __syncthreads();
    PROBE_MARK(2);
    // (c) partial A over this rank's channels, bonus on the diagonal; partial
    // dA over its value columns; a warp a row, a lane a column
    for (int i = tid; i < kCT * kCT; i += kThreads) {
      const int t = i / kCT, j = i % kCT;
      float a = 0.f, da = 0.f;
      if (j < t) {
        for (int c = 0; c < kKC; ++c)
          a = fmaf(r_s[t * kLdc + c] * k_s[j * kLdc + c],
                   wexp(Lp_s[t * kLdc + c], L_s[j * kLdc + c]), a);
      } else if (j == t) {
        for (int c = 0; c < kKC; ++c)
          a = fmaf(r_s[t * kLdc + c] * u_s[c], k_s[t * kLdc + c], a);
      }
      if (j <= t) {
#pragma unroll
        for (int c = 0; c < kKC; c += 4)
          da = dot4(ld4(dy_s + t * kLdv + ch0 + c), ld4(v_s + j * kLdv + ch0 + c), da);
      }
      A_s[t * kLdA + j] = a;
      xdA[t * kLda + j] = da;
    }
    __syncthreads();
    // partial dv over this rank's channels, all columns, 4 rows j a thread:
    // sum_{t>=j} A[t,j] dy[t] + sum_c (k e^(Ll - L))[j, c] G[c]
    for (int i = tid; i < (kCT / 4) * K; i += kThreads) {
      const int j0 = 4 * (i / K), x = i % K;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = j0; t < kCT; ++t) fma4(acc, ld4(A_s + t * kLdA + j0), dy_s[t * kLdv + x]);
#pragma unroll
      for (int c = 0; c < kKC; ++c) fma4(acc, ld4(ksT_s + c * kCT + j0), G_s[c * kLdv + x]);
#pragma unroll
      for (int m = 0; m < 4; ++m) xP[(j0 + m) * kLdv + x] = acc[m];
    }
    PROBE_MARK(3);
    cluster.sync();                    // every rank's partials are written
    PROBE_MARK(4);

    // (d) dA, and dv of this rank's 16 columns: the ranks' partials in rank order
    for (int i = tid; i < kCT * kCT; i += kThreads) {
      const int t = i / kCT, j = i % kCT;
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < NR; ++p) acc += *cluster.map_shared_rank(xdA + t * kLda + j, p);
      dA_s[t * kLda + j] = acc;
    }
    for (int i = tid; i < kCT * kKC; i += kThreads) {
      const int j = i / kKC, c = i % kKC;
      if (j >= nvalid) continue;
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < NR; ++p) acc += *cluster.map_shared_rank(xP + j * kLdv + ch0 + c, p);
      dv[head_off + (size_t)(t0 + j) * row_stride + ch0 + c] = T(acc);
    }
    __syncthreads();
    PROBE_MARK(5);

    // (e) dr, dk of this rank's channels: a thread a (row, channel)
    for (int i = tid; i < kCT * kKC; i += kThreads) {
      const int t = i / kKC, c = i % kKC;
      const float lp = Lp_s[t * kLdc + c], l = L_s[t * kLdc + c];
      const float rt = r_s[t * kLdc + c], kt = k_s[t * kLdc + c];
      float sdy = 0.f, vg = 0.f;       // (S dy[t])_c, (G v[t])_c
#pragma unroll 2
      for (int x = 0; x < K; x += 4) {
        sdy = dot4(ld4(S_s + c * kLdv + x), ld4(dy_s + t * kLdv + x), sdy);
        vg = dot4(ld4(G_s + c * kLdv + x), ld4(v_s + t * kLdv + x), vg);
      }
      float dr_in = 0.f, dk_in = 0.f;
      for (int j = 0; j < t; ++j)
        dr_in = fmaf(dA_s[t * kLda + j] * k_s[j * kLdc + c], wexp(lp, L_s[j * kLdc + c]), dr_in);
      for (int s = t + 1; s < kCT; ++s)
        dk_in = fmaf(dA_s[s * kLda + t] * r_s[s * kLdc + c], wexp(Lp_s[s * kLdc + c], l), dk_in);
      const float dr_x = fmaf(exp_sfu(lp), sdy, dr_in);   // all but the bonus
      const float dk_st = ek_s[t * kLdc + c] * vg;
      const float dk_x = dk_in + dk_st;
      const float bonus = dA_s[t * kLda + t] * u_s[c];
      dLp_s[t * kLdc + c] = rt * dr_x;
      dL_s[t * kLdc + c] = -kt * dk_x;
      kdk_s[t * kLdc + c] = kt * dk_st;
      if (t < nvalid) {
        const size_t off = head_off + (size_t)(t0 + t) * row_stride + ch0 + c;
        dr[off] = T(fmaf(bonus, kt, dr_x));
        dk[off] = T(fmaf(bonus, rt, dk_x));
      }
    }
    __syncthreads();
    PROBE_MARK(6);

    // (f) dw and du: a warp a channel at a time, lane t step t.  dLl = e^Ll
    // (S . G) + sum_t k dk_state; dw[t] = dLl + sum_{s>=t} dL[s] + sum_{s>t}
    // dLp[s] as suffix sums across the lanes
#pragma unroll
    for (int q = 0; q < kKC / kWarps; ++q) {
      const int c = warp + q * kWarps, t = lane;
      float part = kdk_s[t * kLdc + c];
      for (int x = lane; x < K; x += 32)
        part = fmaf(eL_s[c] * S_s[c * kLdv + x], G_s[c * kLdv + x], part);
      float du_t = dA_s[t * kLda + t] * r_s[t * kLdc + c] * k_s[t * kLdc + c];
#pragma unroll
      for (int m = 16; m >= 1; m /= 2) {
        part += __shfl_xor_sync(0xffffffffu, part, m);
        du_t += __shfl_xor_sync(0xffffffffu, du_t, m);
      }
      float s1 = dL_s[t * kLdc + c], s2 = dLp_s[t * kLdc + c];
#pragma unroll
      for (int m = 1; m < 32; m *= 2) {
        const float n1 = __shfl_down_sync(0xffffffffu, s1, m);
        const float n2 = __shfl_down_sync(0xffffffffu, s2, m);
        if (lane + m < 32) {
          s1 += n1;
          s2 += n2;
        }
      }
      float after = __shfl_down_sync(0xffffffffu, s2, 1);   // sum_{s>t} dLp[s]
      if (lane == 31) after = 0.f;
      if (t < nvalid) dw[head_off + (size_t)(t0 + t) * row_stride + ch0 + c] = part + s1 + after;
      du_acc[q] += du_t;               // this chunk's sum, then the chunks' in turn
    }
    __syncthreads();

    // (g) G <- e^Ll G + (r e^Lp)^T dy, this rank's rows
    row_update(G_s, rd_s, dy_s);
    PROBE_MARK(7);
  }
  __syncthreads();
  for (int i = tid; i < kKC * K; i += kThreads) {
    const int rr = i / K, c = i % K;
    ds0[((size_t)bh * K + ch0 + rr) * K + c] = G_s[rr * kLdv + c];
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kKC / kWarps; ++q)
      du_part[(size_t)bh * K + ch0 + warp + q * kWarps] = du_acc[q];
  }
  cluster.sync();                      // peers are done reading this block
  PROBE_END(blockIdx.y * gridDim.x + blockIdx.x);
}

// du[h, c] = sum over the batch of du_part[b, h, c], in batch order
__global__ void __launch_bounds__(kRed)
wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int B, int HK) {
  const int i = blockIdx.x * kRed + threadIdx.x;
  if (i >= HK) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[(size_t)b * HK + i];
  du[i] = s;
}

struct Args {
  const void *r, *k, *v, *w, *u, *s0, *dy, *dsT;
  void *states, *dr, *dk, *dv, *dw, *du_part, *du, *ds0;
  int B, T_len, H, K, C;
};

template <typename T, int K>
int launch_k(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Layout<K>::kBytes;
  static_assert(smem <= 227 * 1024, "fits one block's shared memory");
  static bool smem_set = false;        // once per instantiation, not per launch
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K / kKC, a.B * a.H);
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
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, wkv6_bwd_kernel<T, K>, static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const float*>(a.u), static_cast<const float*>(a.s0),
      static_cast<const T*>(a.dy), static_cast<const float*>(a.dsT),
      static_cast<float*>(a.states), static_cast<T*>(a.dr), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<float*>(a.dw), static_cast<float*>(a.du_part),
      static_cast<float*>(a.ds0), a.T_len, a.H, a.C);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int hk = a.H * K;
  wkv6_bwd_du<<<(hk + kRed - 1) / kRed, kRed, 0, stream>>>(
      static_cast<const float*>(a.du_part), static_cast<float*>(a.du), a.B, hk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, void* stream) {
  if (a.B <= 0 || a.T_len <= 0 || a.H <= 0 || a.C <= 0 || a.C > kCT || a.C > a.T_len ||
      a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.K) {                       // clusters of 1 to 8 ranks
    case 16: return launch_k<T, 16>(a, s);
    case 32: return launch_k<T, 32>(a, s);
    case 48: return launch_k<T, 48>(a, s);
    case 64: return launch_k<T, 64>(a, s);
    case 80: return launch_k<T, 80>(a, s);
    case 96: return launch_k<T, 96>(a, s);
    case 112: return launch_k<T, 112>(a, s);
    case 128: return launch_k<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

PROBE_EXPORT(wkv6_bwd)

extern "C" {

// chunk <= 32; K a multiple of 16 up to 128; operands contiguous; dsT may be
// null (zero); states ((T + chunk - 1) / chunk, B, H, K, K) and du_part (B, H,
// K) fp32 scratch
#define WKV6_BWD_ENTRY(NAME, TYPE)                                                         \
  int NAME(const void* r, const void* k, const void* v, const void* w, const void* u,     \
           const void* s0, const void* dy, const void* dsT, void* states, void* dr,       \
           void* dk, void* dv, void* dw, void* du_part, void* du, void* ds0, int B, int T, \
           int H, int K, int chunk, void* stream) {                                         \
    const Args a{r,  k,  v,  w,  u,       s0, dy,  dsT, states, dr, dk,                    \
                 dv, dw, du_part, du, ds0, B, T, H, K, chunk};                             \
    return launch<TYPE>(a, stream);                                                        \
  }

WKV6_BWD_ENTRY(wkv6_bwd_f32, float)
WKV6_BWD_ENTRY(wkv6_bwd_bf16, __nv_bfloat16)

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
