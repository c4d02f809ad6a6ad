// Mamba-1 selective scan on Hopper (sm_90a); x, dt, B, C and y in fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_pallas (body
// _mamba_kernel).  It computes what the sequential scan computes (the plain
// PyTorch version, kernels/mamba_scan.py::mamba_ref):
//   x, dt  (Bb, T, dI)   T      input and step size (softplus already applied)
//   A      (dI, dS)      fp32   state decay rates, < 0
//   B, C   (Bb, T, dS)   T      input and output projections of the state;
//                               rows may be strided (column slices of `proj`)
//   D      (dI,)         fp32   skip connection
//   s0     (Bb, dI, dS)  fp32   state carried in
//   y      (Bb, T, dI)   T      output
//   sT     (Bb, dI, dS)  fp32   state after the last step
// per step t (all fp32):
//   h    = exp(dt_t * A) * h + (dt_t * x_t) * B_t      (dI, dS)
//   y_t  = sum_s h[:, s] * C_t[s] + D * x_t
//
// Bound: memory.  A call must read x, dt, A, B, C, D and s0 once and write y and
// sT once: at a 32-token prefill chunk of Jamba (Bb = 1, dI = 8192, dS = 16,
// bf16 x/dt/y/B/C) about 3.18 MB, 0.95 us at 3.35 TB/s.  The 4.2 M
// exponentials take about 1 us on the SFUs.  A serving call is one 32-step
// tile, so what counts is the latency of one pass.
//
// Design.  The TPU kernel tiles dI by 512 lanes, carries the (512, dS) state in
// VMEM scratch across a sequential chunk axis of the grid and pads T to its
// chunk with dt = 0.  Hopper blocks run in no order, so:
//   * one block per (batch row, 32 channels) walks all T steps in a loop; each
//     thread owns E = 4 consecutive state entries of one channel and keeps
//     them in registers for the whole call: dS / E lanes a channel (dS 16:
//     4 lanes, blocks of 4 warps, 256 blocks at Bb 1, dI 8192; E 2 and 8
//     measured slower at that shape).
//     y_t's sum is taken over the thread's E entries in registers; the sums
//     over a channel's lanes wait until a group of U = 8 steps is
//     done, then take a transposed butterfly: 24 shuffles a tile at 4 lanes,
//     not 64;
//   * exp(dt A) is ex2.approx of dt * (A log2 e), A prescaled in registers;
//   * time is staged in tiles of 32 steps: the block's x and dt columns and
//     B_t, C_t rows (shared by all its channels) are cp.async-copied, 16 bytes
//     at a time, into one of two shared buffers, so the next tile's copies fly
//     while this one is computed (scalar loads where a row is not 16-byte
//     aligned); y is gathered in shared memory and written out per tile;
//   * a group's U steps (8; 32 measured no faster, 4 and 16 slower) are
//     unrolled with no shuffle or store among them: only h = da h + dx B is
//     a dependent chain, so the steps' exponentials and output products
//     overlap it;
//   * a ragged T needs no branch: steps past T are zero-filled (dt = 0 leaves
//     the state unchanged, as the reference's padding does) and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "scan_probe.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTile = 32;   // time steps staged per pass
constexpr int kCh = 32;     // channels of a block
constexpr int kEntries = 4; // state entries a thread owns
constexpr int kUnroll = 8;  // steps unrolled between cross-lane sums (divides kTile)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int DS>
struct Shape {
  static constexpr int E = kEntries < DS ? kEntries : DS;   // entries a thread
  static constexpr int LPC = DS / E;                        // lanes a channel
  static constexpr int NT = kCh * LPC;                      // threads a block
  static constexpr int U = kUnroll > LPC ? kUnroll : LPC;   // steps a group
  static_assert(DS % E == 0 && 32 % LPC == 0, "a channel's lanes share a warp");
  static_assert(kTile % U == 0, "groups divide the tile");
};

// One level of the transposed cross-lane sum: lanes whose `bit` is set keep
// the upper HALF of their steps, the others the lower, and each adds its
// partner's shares of the steps it keeps.  Returns the first kept step.
template <int HALF, int BIT, int N>
__device__ __forceinline__ int fold(float (&p)[N], int sub) {
  const bool upper = (sub & BIT) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? p[i] : p[i + HALF];
    const float keep = upper ? p[i + HALF] : p[i];
    p[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
  return upper ? HALF : 0;
}

// p[i] (this lane's share of step i of a group of N) summed over the
// channel's LPC lanes: afterwards p[0 .. N / LPC) hold the sums of steps
// s0 .. s0 + N / LPC, s0 returned; N (1 - 1 / LPC) shuffles a lane.
template <int LPC, int N>
__device__ __forceinline__ int lane_sums(float (&p)[N], int sub) {
  int s0 = 0;
  if constexpr (LPC >= 2) s0 += fold<N / 2, LPC / 2>(p, sub);
  if constexpr (LPC >= 4) s0 += fold<N / 4, LPC / 4>(p, sub);
  if constexpr (LPC >= 8) s0 += fold<N / 8, LPC / 8>(p, sub);
  if constexpr (LPC >= 16) s0 += fold<N / 16, LPC / 16>(p, sub);
  static_assert(LPC <= 16, "at most 16 lanes a channel");
  return s0;
}

template <typename T, int DS>
__global__ void __launch_bounds__(Shape<DS>::NT) mamba_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT, int T_len,
    int dI, long long b_sb, long long b_st, long long c_sb, long long c_st, int vec_x,
    int vec_bc) {
  constexpr int E = Shape<DS>::E, LPC = Shape<DS>::LPC, NT = Shape<DS>::NT;
  constexpr int U = Shape<DS>::U;
  constexpr int VE = 16 / sizeof(T);          // elements of a 16-byte copy
  __shared__ __align__(16) T x_s[2][kTile][kCh];
  __shared__ __align__(16) T dt_s[2][kTile][kCh];
  __shared__ __align__(16) T B_s[2][kTile][DS];
  __shared__ __align__(16) T C_s[2][kTile][DS];
  __shared__ float y_s[kTile][kCh + 1];
  PROBE_START();

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int lc = tid / LPC;           // channel within the block
  const int sub = tid % LPC;          // which E entries of it
  const int c = c0 + lc;
  const bool live = c < dI;
  const T* xb = x + (size_t)b * T_len * dI;
  const T* dtb = dt + (size_t)b * T_len * dI;
  T* yb = y + (size_t)b * T_len * dI;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  // one tile's copies into buffer buf; steps past T and channels past dI are 0
  auto stage = [&](int t0, int buf) {
    if (vec_x) {
      constexpr int XC = kCh / VE;             // 16-byte chunks of a tile row
      for (int i = tid; i < 2 * kTile * XC; i += NT) {
        const int arr = i / (kTile * XC), j = i % (kTile * XC);
        const int tt = j / XC, ch = c0 + (j % XC) * VE;
        const bool ok = t0 + tt < T_len && ch < dI;
        const T* src = (arr ? dtb : xb) + (size_t)(t0 + tt) * dI + ch;
        T* dst = arr ? &dt_s[buf][tt][(j % XC) * VE] : &x_s[buf][tt][(j % XC) * VE];
        sm90::cp_async16(sm90::smem_addr(dst), ok ? src : xb, ok);
      }
    } else {
      for (int i = tid; i < kTile * kCh; i += NT) {
        const int tt = i / kCh, cc = i % kCh, ch = c0 + cc;
        const bool ok = t0 + tt < T_len && ch < dI;
        const size_t off = (size_t)(t0 + tt) * dI + ch;
        x_s[buf][tt][cc] = ok ? xb[off] : T(0.f);
        dt_s[buf][tt][cc] = ok ? dtb[off] : T(0.f);
      }
    }
    bool bc_copied = false;            // 16-byte copies need a row of 16 bytes or more
    if constexpr (DS % VE == 0) {
      if (vec_bc) {
        constexpr int BC = DS / VE;    // 16-byte chunks of a B / C row
        for (int i = tid; i < 2 * kTile * BC; i += NT) {
          const int arr = i / (kTile * BC), j = i % (kTile * BC);
          const int tt = j / BC, e = (j % BC) * VE;
          const bool ok = t0 + tt < T_len;
          const T* src = arr ? Cb + (t0 + tt) * c_st + e : Bb + (t0 + tt) * b_st + e;
          T* dst = arr ? &C_s[buf][tt][e] : &B_s[buf][tt][e];
          sm90::cp_async16(sm90::smem_addr(dst), ok ? src : Bb, ok);
        }
        bc_copied = true;
      }
    }
    if (!bc_copied) {
      for (int i = tid; i < kTile * DS; i += NT) {
        const int tt = i / DS, e = i % DS;
        const bool ok = t0 + tt < T_len;
        B_s[buf][tt][e] = ok ? Bb[(t0 + tt) * b_st + e] : T(0.f);
        C_s[buf][tt][e] = ok ? Cb[(t0 + tt) * c_st + e] : T(0.f);
      }
    }
    sm90::cp_async_commit();
  };

  stage(0, 0);
  float a2[E], h[E], d = 0.f;   // A log2(e), the state entries, D
#pragma unroll
  for (int e = 0; e < E; ++e) a2[e] = h[e] = 0.f;
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a2[e] = A[(size_t)c * DS + sub * E + e] * kLog2e;
      h[e] = s0[((size_t)b * dI + c) * DS + sub * E + e];
    }
    d = D[c];
  }

  const int n_tiles = (T_len + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kTile, buf = it & 1;
    if (it + 1 < n_tiles) {            // the other buffer: read by tile it - 1, done
      stage(t0 + kTile, buf ^ 1);
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    PROBE_MARK(0);

#pragma unroll 1
    for (int g0 = 0; g0 < kTile; g0 += U) {
      float p[U];                      // this lane's share of each step's y
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int tt = g0 + i;
        const float xv = to_f32(x_s[buf][tt][lc]);
        const float dv = to_f32(dt_s[buf][tt][lc]);
        const float dx = dv * xv;
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float da = sm90::fast_exp2(dv * a2[e]);
          h[e] = fmaf(da, h[e], dx * to_f32(B_s[buf][tt][sub * E + e]));
          acc = fmaf(h[e], to_f32(C_s[buf][tt][sub * E + e]), acc);
        }
        p[i] = acc;
      }
      const int s0 = g0 + lane_sums<LPC>(p, sub);
#pragma unroll
      for (int i = 0; i < U / LPC; ++i)
        y_s[s0 + i][lc] = fmaf(d, to_f32(x_s[buf][s0 + i][lc]), p[i]);
    }
    __syncthreads();
    PROBE_MARK(1);

    const int n = min(kTile, T_len - t0);
    if (vec_x) {
      constexpr int XC = kCh / VE;
      for (int i = tid; i < n * XC; i += NT) {
        const int tt = i / XC, cc = (i % XC) * VE;
        if (c0 + cc >= dI) continue;
        alignas(16) T out[VE];
#pragma unroll
        for (int e = 0; e < VE; ++e) out[e] = T(y_s[tt][cc + e]);
        *reinterpret_cast<uint4*>(yb + (size_t)(t0 + tt) * dI + c0 + cc) =
            *reinterpret_cast<const uint4*>(out);
      }
    } else {
      for (int i = tid; i < n * kCh; i += NT) {
        const int tt = i / kCh, cc = i % kCh;
        if (c0 + cc < dI) yb[(size_t)(t0 + tt) * dI + c0 + cc] = T(y_s[tt][cc]);
      }
    }
    PROBE_MARK(2);
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) sT[((size_t)b * dI + c) * DS + sub * E + e] = h[e];
  }
  PROBE_MARK(3);
  PROBE_END(blockIdx.y * gridDim.x + blockIdx.x);
}

template <typename T, int DS>
int launch_ds(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
              const void* D, const void* s0, void* y, void* sT, int Bb, int T_len, int dI,
              long long b_sb, long long b_st, long long c_sb, long long c_st,
              void* stream) {
  constexpr int el = sizeof(T);
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // 16-byte copies: x, dt and y rows, and B and C rows, each where aligned
  const int vec_x = (long long)dI * el % 16 == 0 && al16(x) && al16(dt) && al16(y);
  const int vec_bc = DS * el % 16 == 0 && b_st * el % 16 == 0 && c_st * el % 16 == 0 &&
                     b_sb * el % 16 == 0 && c_sb * el % 16 == 0 && al16(Bm) && al16(Cm);
  const dim3 grid((dI + kCh - 1) / kCh, Bb);
  mamba_scan_kernel<T, DS><<<grid, Shape<DS>::NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(sT), T_len,
      dI, b_sb, b_st, c_sb, c_st, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* D, const void* s0, void* y, void* sT, int Bb, int T_len, int dI,
           int dS, long long b_sb, long long b_st, long long c_sb, long long c_st,
           void* stream) {
  if (Bb <= 0 || Bb > 65535 || T_len <= 0 || dI <= 0) return (int)cudaErrorInvalidValue;
  switch (dS) {
    case 4:
      return launch_ds<T, 4>(x, dt, A, Bm, Cm, D, s0, y, sT, Bb, T_len, dI, b_sb, b_st,
                             c_sb, c_st, stream);
    case 8:
      return launch_ds<T, 8>(x, dt, A, Bm, Cm, D, s0, y, sT, Bb, T_len, dI, b_sb, b_st,
                             c_sb, c_st, stream);
    case 16:
      return launch_ds<T, 16>(x, dt, A, Bm, Cm, D, s0, y, sT, Bb, T_len, dI, b_sb, b_st,
                              c_sb, c_st, stream);
    case 32:
      return launch_ds<T, 32>(x, dt, A, Bm, Cm, D, s0, y, sT, Bb, T_len, dI, b_sb, b_st,
                              c_sb, c_st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

PROBE_EXPORT(mamba_scan)

extern "C" {

int mamba_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* D, const void* s0, void* y, void* sT, int Bb,
                   int T, int dI, int dS, long long b_sb, long long b_st, long long c_sb,
                   long long c_st, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, D, s0, y, sT, Bb, T, dI, dS, b_sb, b_st, c_sb,
                       c_st, stream);
}

int mamba_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                    const void* Cm, const void* D, const void* s0, void* y, void* sT, int Bb,
                    int T, int dI, int dS, long long b_sb, long long b_st, long long c_sb,
                    long long c_st, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, s0, y, sT, Bb, T, dI, dS, b_sb, b_st,
                               c_sb, c_st, stream);
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
