// Backward of the Mamba-1 selective scan on Hopper (sm_90a); x, dt, B, C, dy
// and dx, ddt, dB, dC in fp32 or bf16, everything else fp32.
//
// No TPU kernel had a backward: the reference trains through its chunked XLA
// form with each chunk under jax.checkpoint (repro/kernels/ops.py,
// mamba_chunked).  This is the backward of the port's MambaScan autograd
// Function, whose forward is csrc/mamba_scan.cu; it computes the gradient of
// that scan, which kernels/mamba_scan.py::mamba_chunked_bwd computes in plain
// PyTorch and mamba_bwd_tiled follows step for step (the same tiles, saved
// states and partial sums).  For the cotangents dy (Bb, T, dI) and dsT (Bb,
// dI, dS, or none) of (y, the final state), with a_t = exp(dt_t A) and g_t the
// gradient of h_t (from y_t and every later step), walking t backwards:
//   g    += dy_t C_t                             (Bb, dI, dS)
//   dx_t  = D dy_t + dt_t sum_s g B_t
//   ddt_t = sum_s g (x_t B_t + A a_t h_{t-1})
//   dA   += g dt_t a_t h_{t-1}          dB_t += sum_i g dt_t x_t
//   dC_t += sum_i dy_t h_t              dD   += dy_t x_t
//   g     = a_t g                       (after step 1: dstate0)
//
// Bound: memory and the special-function units.  A call reads x, dt, B, C, dy
// (compute dtype), A, D, the state and its cotangent (fp32) once and writes
// dx, ddt, dB, dC, dA, dD and dstate0 once: at Jamba's training call (Bb 1,
// T 2048, dI 8192, dS 16, bf16) about 168 MB, 0.05 ms at 3.35 TB/s, and it
// needs at least one exponential per (t, i, s), 268 M of them.
//
// Design (right and deterministic first; a later redesign may stage with TMA):
//   * The forward's layout: one block per (batch row, 32 channels), a thread
//     owning E = 4 state entries of one channel; nothing is divided by a_t.
//   * Pass 1 runs the forward recurrence and stores the state at the start of
//     each 32-step tile to a scratch buffer (Bb x dI x dS fp32 a tile: 34 MB
//     at the training call).  Each thread reads back only what it wrote.
//   * Pass 2 walks the tiles in reverse: it recomputes the tile's h_{t-1}
//     from the stored state into shared memory (a float4 a thread a step),
//     then walks the tile's steps backwards in unrolled groups of U = 8.
//   * dA and dD add a tile's 32 terms first, then the tiles' sums in turn.
//   * Sums over a channel's LPC lanes (dx, ddt) and over the warp's channels
//     (dB, dC) take the transposed folds of csrc/lane_sums.cuh once a group;
//     the warps' sums of dB_t, dC_t are added in warp order and written as the
//     block's partial (Bb, dI / 32, T, dS).  A second kernel adds the blocks'
//     partials in block order, and dA and dD over the batch rows: no atomics,
//     so two calls are bitwise equal.
//   * B and C may be strided column slices of one projection (their row and
//     batch strides are arguments); dB and dC come back contiguous.
//   * exp(dt A) is expf, not the forward's ex2.approx of dt * (A log2 e): the
//     approximation's error is nearly the same for the nearby arguments of a
//     slowly decaying channel, so it compounds along g and h over the
//     channel's memory (~1 / (dt |A|) steps).  With ex2.approx, dA at Jamba's
//     training call (fp32) stood 6.2e-6 of max |dA| from the plain backward,
//     which is itself within 7.1e-7 of the float64 sequential gradient there
//     (chip_smoke.py phase 2 prints both distances).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "lane_sums.cuh"

namespace {

constexpr int kTile = 32;   // time steps a tile (the stored states' spacing)
constexpr int kCh = 32;     // channels of a block
constexpr int kEntries = 4; // state entries a thread owns
constexpr int kUnroll = 8;  // steps a group between cross-lane sums
constexpr int kRed = 256;   // threads of a reduction block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int DS>
struct Shape {
  static constexpr int E = kEntries;                        // entries a thread
  static constexpr int LPC = DS / E;                        // lanes a channel
  static constexpr int NT = kCh * LPC;                      // threads a block
  static constexpr int NW = NT / 32;                        // warps a block
  static constexpr int CPW = 32 / LPC;                      // channels a warp
  static constexpr int U = kUnroll > LPC ? kUnroll : LPC;   // steps a group
  static constexpr int KEEP = U * E / CPW;                  // values a lane keeps
  static_assert(DS % E == 0 && 32 % LPC == 0, "a channel's lanes share a warp");
  static_assert(kTile % U == 0 && KEEP >= 1, "groups divide the tile");
  // shared memory: h_{t-1} (kTile x NT float4), then fp32 x, dt, dy (kTile x
  // kCh), B, C (kTile x DS), dx, ddt (kTile x (kCh + 1)), the warps' dB, dC
  // (NW x kTile x DS)
  static constexpr size_t kBytes =
      (size_t)kTile * NT * 16 +
      4 * ((size_t)3 * kTile * kCh + 2 * kTile * DS + 2 * kTile * (kCh + 1) +
           2 * (size_t)NW * kTile * DS);
};

template <typename T, int DS>
__global__ void __launch_bounds__(Shape<DS>::NT) mamba_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ s0, const T* __restrict__ dy, const float* __restrict__ dsT,
    float* __restrict__ hbuf, T* __restrict__ dx, T* __restrict__ ddt,
    float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dAp,
    float* __restrict__ dDp, float* __restrict__ ds0, int Bb, int T_len, int dI,
    long long b_sb, long long b_st, long long c_sb, long long c_st) {
  using Sh = Shape<DS>;
  constexpr int E = Sh::E, LPC = Sh::LPC, NT = Sh::NT, NW = Sh::NW, U = Sh::U;
  constexpr int XL = kCh + 1;
  extern __shared__ __align__(16) float4 smem4[];
  float4* hp_s = smem4;                                   // [kTile][NT]
  float* x_s = reinterpret_cast<float*>(hp_s + kTile * NT);   // [kTile][kCh]
  float* dt_s = x_s + kTile * kCh;
  float* dy_s = dt_s + kTile * kCh;
  float* B_s = dy_s + kTile * kCh;                        // [kTile][DS]
  float* C_s = B_s + kTile * DS;
  float* dx_s = C_s + kTile * DS;                         // [kTile][XL]
  float* ddt_s = dx_s + kTile * XL;
  float* pB_s = ddt_s + kTile * XL;                       // [NW][kTile][DS]
  float* pC_s = pB_s + NW * kTile * DS;

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int c0 = blk * kCh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lc = tid / LPC;           // channel within the block
  const int sub = tid % LPC;          // which E entries of it
  const int c = c0 + lc;
  const bool live = c < dI;
  const size_t row = (size_t)b * T_len * dI;
  const T* Bb_ = Bm + b * b_sb;
  const T* Cb_ = Cm + b * c_sb;
  const size_t ent = ((size_t)b * dI + c) * DS + sub * E;   // this thread's entries
  const size_t tile_stride = (size_t)Bb * dI * DS;           // hbuf: a tile's states

  // one tile into shared memory as fp32; steps past T and channels past dI are 0
  auto stage = [&](int t0, bool backward) {
    for (int i = tid; i < kTile * kCh; i += NT) {
      const int tt = i / kCh, ch = c0 + i % kCh;
      const bool ok = t0 + tt < T_len && ch < dI;
      const size_t off = row + (size_t)(t0 + tt) * dI + ch;
      x_s[i] = ok ? to_f32(x[off]) : 0.f;
      dt_s[i] = ok ? to_f32(dt[off]) : 0.f;
      if (backward) dy_s[i] = ok ? to_f32(dy[off]) : 0.f;
    }
    for (int i = tid; i < kTile * DS; i += NT) {
      const int tt = i / DS, e = i % DS;
      const bool ok = t0 + tt < T_len;
      B_s[i] = ok ? to_f32(Bb_[(t0 + tt) * b_st + e]) : 0.f;
      if (backward) C_s[i] = ok ? to_f32(Cb_[(t0 + tt) * c_st + e]) : 0.f;
    }
  };

  float av[E], h[E], d = 0.f;          // A, the state entries, D
#pragma unroll
  for (int e = 0; e < E; ++e) av[e] = h[e] = 0.f;
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      av[e] = A[(size_t)c * DS + sub * E + e];
      h[e] = s0[ent + e];
    }
    d = D[c];
  }
  // one step of the forward recurrence
  auto step = [&](float (&hh)[E], int tt) {
    const float dv = dt_s[tt * kCh + lc];
    const float dxv = dv * x_s[tt * kCh + lc];
#pragma unroll
    for (int e = 0; e < E; ++e)
      hh[e] = fmaf(expf(dv * av[e]), hh[e], dxv * B_s[tt * DS + sub * E + e]);
  };

  // ---- pass 1: the state at each tile's start ----
  const int n_tiles = (T_len + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    if (live)
      *reinterpret_cast<float4*>(hbuf + it * tile_stride + ent) =
          make_float4(h[0], h[1], h[2], h[3]);
    if (it + 1 == n_tiles) break;
    __syncthreads();                   // the previous tile's reads are done
    stage(it * kTile, false);
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < kTile; ++tt) step(h, tt);
  }

  // ---- pass 2: the tiles in reverse ----
  float g[E], dA[E], dD = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    g[e] = live && dsT != nullptr ? dsT[ent + e] : 0.f;
    dA[e] = 0.f;
  }
  for (int it = n_tiles - 1; it >= 0; --it) {
    const int t0 = it * kTile;
    float dAt[E], dDt = 0.f;           // this tile's terms, added to dA, dD at its end
#pragma unroll
    for (int e = 0; e < E; ++e) dAt[e] = 0.f;
    __syncthreads();                   // the previous tile's reads are done
    stage(t0, true);
    float hh[E] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float4 q = *reinterpret_cast<const float4*>(hbuf + it * tile_stride + ent);
      hh[0] = q.x; hh[1] = q.y; hh[2] = q.z; hh[3] = q.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < kTile; ++tt) {   // h_{t-1} of each step, this thread's own
      hp_s[tt * NT + tid] = make_float4(hh[0], hh[1], hh[2], hh[3]);
      step(hh, tt);
    }

#pragma unroll 1
    for (int g0 = kTile - U; g0 >= 0; g0 -= U) {
      float px[U], pdt[U], pB[U * E], pC[U * E];
#pragma unroll
      for (int i = U - 1; i >= 0; --i) {
        const int tt = g0 + i;
        const float xv = x_s[tt * kCh + lc], dv = dt_s[tt * kCh + lc];
        const float dyv = dy_s[tt * kCh + lc];
        const float dxv = dv * xv;
        const float4 q = hp_s[tt * NT + tid];
        const float hprev[4] = {q.x, q.y, q.z, q.w};
        float sx = 0.f, sdt = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float a = expf(dv * av[e]);
          const float bv = B_s[tt * DS + sub * E + e];
          const float cv = C_s[tt * DS + sub * E + e];
          const float ah = a * hprev[e];
          pC[i * E + e] = dyv * fmaf(a, hprev[e], dxv * bv);   // dy_t h_t
          g[e] = fmaf(dyv, cv, g[e]);
          pB[i * E + e] = g[e] * dxv;
          sx = fmaf(g[e], bv, sx);
          sdt = fmaf(g[e], fmaf(xv, bv, av[e] * ah), sdt);
          dAt[e] = fmaf(g[e] * dv, ah, dAt[e]);
          g[e] *= a;
        }
        px[i] = sx;
        pdt[i] = sdt;
        dDt = fmaf(dyv, xv, dDt);
      }
      // dx, ddt: over the channel's lanes
      const int sx0 = g0 + scan::lane_sums<LPC>(px, sub);
      scan::lane_sums<LPC>(pdt, sub);
#pragma unroll
      for (int i = 0; i < U / LPC; ++i) {
        const int tt = sx0 + i;
        dx_s[tt * XL + lc] = fmaf(dt_s[tt * kCh + lc], px[i], d * dy_s[tt * kCh + lc]);
        ddt_s[tt * XL + lc] = pdt[i];
      }
      // dB, dC: over the warp's channels
      const int sb0 = scan::channel_sums<U * E / 2, LPC>(pB, lane);
      scan::channel_sums<U * E / 2, LPC>(pC, lane);
#pragma unroll
      for (int j = 0; j < Sh::KEEP; ++j) {
        const int idx = sb0 + j, i = idx / E, e = idx % E;
        const int o = (warp * kTile + g0 + i) * DS + sub * E + e;
        pB_s[o] = pB[j];
        pC_s[o] = pC[j];
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dA[e] += dAt[e];
    dD += dDt;
    __syncthreads();

    const int n = min(kTile, T_len - t0);
    for (int i = tid; i < n * kCh; i += NT) {
      const int tt = i / kCh, cc = i % kCh;
      if (c0 + cc >= dI) continue;
      const size_t off = row + (size_t)(t0 + tt) * dI + c0 + cc;
      dx[off] = T(dx_s[tt * XL + cc]);
      ddt[off] = T(ddt_s[tt * XL + cc]);
    }
    for (int i = tid; i < n * DS; i += NT) {   // the block's partial: warps in order
      const int tt = i / DS, s = i % DS;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        sb += pB_s[(w * kTile + tt) * DS + s];
        sc += pC_s[(w * kTile + tt) * DS + s];
      }
      const size_t o = (((size_t)b * nblk + blk) * T_len + t0 + tt) * DS + s;
      dBp[o] = sb;
      dCp[o] = sc;
    }
  }

  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ds0[ent + e] = g[e];
      dAp[ent + e] = dA[e];
    }
    if (sub == 0) dDp[(size_t)b * dI + c] = dD;
  }
}

// dB, dC: the blocks' partials added in block order; dA, dD: the batch rows'
template <typename T>
__global__ void __launch_bounds__(kRed) mamba_bwd_reduce(
    const float* __restrict__ dBp, const float* __restrict__ dCp,
    const float* __restrict__ dAp, const float* __restrict__ dDp, T* __restrict__ dB,
    T* __restrict__ dC, float* __restrict__ dA, float* __restrict__ dD, int Bb, int T_len,
    int dI, int DS, int nblk) {
  const long long i = (long long)blockIdx.x * kRed + threadIdx.x;
  const long long per_b = (long long)T_len * DS;
  const long long n_bc = Bb * per_b, n_a = (long long)dI * DS;
  if (i < n_bc) {
    const long long b = i / per_b, rest = i % per_b;
    const float* pb = dBp + b * nblk * per_b + rest;
    const float* pc = dCp + b * nblk * per_b + rest;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      sb += pb[k * per_b];
      sc += pc[k * per_b];
    }
    dB[i] = T(sb);
    dC[i] = T(sc);
  } else if (i < n_bc + n_a) {
    const long long j = i - n_bc;
    float s = 0.f;
    for (int b = 0; b < Bb; ++b) s += dAp[b * n_a + j];
    dA[j] = s;
  } else if (i < n_bc + n_a + dI) {
    const long long j = i - n_bc - n_a;
    float s = 0.f;
    for (int b = 0; b < Bb; ++b) s += dDp[(long long)b * dI + j];
    dD[j] = s;
  }
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *D, *s0, *dy, *dsT;
  void *hbuf, *dx, *ddt, *dBp, *dCp, *dAp, *dDp, *ds0, *dB, *dC, *dA, *dD;
  int Bb, T_len, dI, dS;
  long long b_sb, b_st, c_sb, c_st;
};

template <typename T, int DS>
int launch_ds(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Shape<DS>::kBytes;
  static_assert(smem <= 227 * 1024, "fits one block's shared memory");
  static bool smem_set = false;        // once per instantiation, not per launch
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_bwd_kernel<T, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int nblk = (a.dI + kCh - 1) / kCh;
  mamba_bwd_kernel<T, DS><<<dim3(nblk, a.Bb), Shape<DS>::NT, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<const float*>(a.D),
      static_cast<const float*>(a.s0), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.dsT), static_cast<float*>(a.hbuf),
      static_cast<T*>(a.dx), static_cast<T*>(a.ddt), static_cast<float*>(a.dBp),
      static_cast<float*>(a.dCp), static_cast<float*>(a.dAp), static_cast<float*>(a.dDp),
      static_cast<float*>(a.ds0), a.Bb, a.T_len, a.dI, a.b_sb, a.b_st, a.c_sb, a.c_st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)a.Bb * a.T_len * DS + (long long)a.dI * DS + a.dI;
  mamba_bwd_reduce<T><<<(unsigned)((n + kRed - 1) / kRed), kRed, 0, stream>>>(
      static_cast<const float*>(a.dBp), static_cast<const float*>(a.dCp),
      static_cast<const float*>(a.dAp), static_cast<const float*>(a.dDp),
      static_cast<T*>(a.dB), static_cast<T*>(a.dC), static_cast<float*>(a.dA),
      static_cast<float*>(a.dD), a.Bb, a.T_len, a.dI, DS, nblk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, void* stream) {
  if (a.Bb <= 0 || a.Bb > 65535 || a.T_len <= 0 || a.dI <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.dS) {
    case 4: return launch_ds<T, 4>(a, s);
    case 8: return launch_ds<T, 8>(a, s);
    case 16: return launch_ds<T, 16>(a, s);
    case 32: return launch_ds<T, 32>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, dt, dy, dx, ddt (Bb, T, dI) and dB, dC (Bb, T, dS) contiguous; B, C
// strided over (Bb, T) with a unit stride over dS; dsT may be null (zero);
// hbuf (ceil(T / 32), Bb, dI, dS), dBp and dCp (Bb, ceil(dI / 32), T, dS),
// dAp (Bb, dI, dS) and dDp (Bb, dI) fp32 scratch; hbuf and the state
// tensors 16-byte aligned
#define MAMBA_BWD_ENTRY(NAME, TYPE)                                                        \
  int NAME(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,  \
           const void* D, const void* s0, const void* dy, const void* dsT, void* hbuf,    \
           void* dx, void* ddt, void* dBp, void* dCp, void* dAp, void* dDp, void* ds0,    \
           void* dB, void* dC, void* dA, void* dD, int Bb, int T, int dI, int dS,         \
           long long b_sb, long long b_st, long long c_sb, long long c_st, void* stream) { \
    const Args a{x,   dt,  A,   Bm,  Cm,  D,   s0, dy, dsT, hbuf, dx, ddt, dBp, dCp, dAp,  \
                 dDp, ds0, dB,  dC,  dA,  dD,  Bb, T,  dI,  dS,   b_sb, b_st, c_sb, c_st}; \
    return launch<TYPE>(a, stream);                                                        \
  }

MAMBA_BWD_ENTRY(mamba_scan_bwd_f32, float)
MAMBA_BWD_ENTRY(mamba_scan_bwd_bf16, __nv_bfloat16)

const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
