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
// Design.  The TPU kernel tiles dI by 512 lanes, carries the (512, dS) state in
// VMEM scratch across a sequential chunk axis of the grid and pads T to its
// chunk with dt = 0.  Hopper blocks run in no order, so:
//   * one block per (batch row, tile of 256 / dS channels) walks all T steps in
//     a loop; each of its threads owns one (channel, state) entry of h and keeps
//     it in a register for the whole call -- dS lanes per channel, so a
//     256-thread block covers 16 channels at dS = 16 (512 blocks at Bb = 1,
//     dI = 8192, one wave on 132 SMs);
//   * time is staged in tiles of kTile steps: the block's x and dt columns and
//     B_t, C_t (shared by all its channels) go to shared memory as fp32, with
//     coalesced loads; y is gathered in shared memory and written out per tile;
//   * y_t's sum over the dS lanes of a channel is a butterfly of __shfl_xor_sync
//     inside the warp (dS divides 32);
//   * a ragged T needs no padding: the loop stops at T (the reference's dt = 0
//     padding leaves the state unchanged, so the results agree).
//
// Bound: memory.  A call must read x, dt, A, B, C, D and s0 once and write y and
// sT once: at a 32-token prefill chunk of Jamba (Bb = 1, dI = 8192, dS = 16,
// bf16 x/dt/y/B/C) about 3.18 MB, 0.95 us at 3.35 TB/s.  The 4.2 M exponentials
// of that call take about 1 us on the SFUs (16 a clock per SM); the FMAs less.
// Each step of a block's loop is a dependent chain (exp, FMA, 4 shuffles), so a
// short chunk is latency-bound: this first version makes no attempt to overlap
// the next tile's loads with the current tile's steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // time steps staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT, int T_len,
    int dI, long long b_sb, long long b_st, long long c_sb, long long c_st) {
  constexpr int CH = kThreads / DS;   // channels of this block
  __shared__ float x_s[kTile][CH];
  __shared__ float dt_s[kTile][CH];
  __shared__ float y_s[kTile][CH];
  __shared__ float B_s[kTile][DS];
  __shared__ float C_s[kTile][DS];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int lc = tid / DS;            // channel within the block
  const int s = tid % DS;             // state entry
  const int c = c0 + lc;
  const bool live = c < dI;

  float a = 0.f, h = 0.f, d = 0.f;
  if (live) {
    a = A[(size_t)c * DS + s];
    h = s0[((size_t)b * dI + c) * DS + s];
    d = D[c];
  }
  const T* xb = x + (size_t)b * T_len * dI;
  const T* dtb = dt + (size_t)b * T_len * dI;
  T* yb = y + (size_t)b * T_len * dI;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  for (int t0 = 0; t0 < T_len; t0 += kTile) {
    const int n = min(kTile, T_len - t0);
    for (int i = tid; i < n * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH, ch = c0 + cc;
      const size_t off = (size_t)(t0 + tt) * dI + ch;
      x_s[tt][cc] = ch < dI ? to_f32(xb[off]) : 0.f;
      dt_s[tt][cc] = ch < dI ? to_f32(dtb[off]) : 0.f;
    }
    for (int i = tid; i < n * DS; i += kThreads) {
      const int tt = i / DS, ss = i % DS;
      B_s[tt][ss] = to_f32(Bb[(t0 + tt) * b_st + ss]);
      C_s[tt][ss] = to_f32(Cb[(t0 + tt) * c_st + ss]);
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float xv = x_s[tt][lc];
      const float dv = dt_s[tt][lc];
      h = expf(dv * a) * h + (dv * xv) * B_s[tt][s];
      float p = h * C_s[tt][s];
#pragma unroll
      for (int off = DS / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (s == 0) y_s[tt][lc] = p + d * xv;
    }
    __syncthreads();

    for (int i = tid; i < n * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH, ch = c0 + cc;
      if (ch < dI) store_out(yb + (size_t)(t0 + tt) * dI + ch, y_s[tt][cc]);
    }
    __syncthreads();   // the next pass overwrites the staged tiles
  }
  if (live) sT[((size_t)b * dI + c) * DS + s] = h;
}

template <typename T, int DS>
int launch_ds(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
              const void* D, const void* s0, void* y, void* sT, int Bb, int T_len, int dI,
              long long b_sb, long long b_st, long long c_sb, long long c_st,
              void* stream) {
  constexpr int CH = kThreads / DS;
  const dim3 grid((dI + CH - 1) / CH, Bb);
  mamba_scan_kernel<T, DS><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(sT), T_len,
      dI, b_sb, b_st, c_sb, c_st);
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
