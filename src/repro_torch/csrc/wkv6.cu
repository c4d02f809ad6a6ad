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
// per chunk of C steps (all fp32):
//   L = cumsum_t w (inclusive), Lp = L - w (exclusive)
//   y[t]  = (r[t] * exp(Lp[t])) @ S                            carried state
//         + sum_{j<t} (sum_k r[t,k] k[j,k] exp(clip(Lp[t,k] - L[j,k], -60, 0))) v[j]
//         + (sum_k r[t,k] u[k] k[t,k]) v[t]                    bonus
//   S'    = exp(L[C-1]) * S + (k * exp(L[C-1] - L))^T @ v
// A ragged tail (T not a multiple of C) counts its missing rows as r = k = v =
// 0 and w = 0, which is what the reference's zero padding computes; nothing is
// padded in memory.
//
// Design.  The TPU kernel walks a (B*H, T/C) grid whose chunk axis runs in
// order and carries S in VMEM scratch.  Hopper blocks run in no order, so:
//   * one block per (b, h, tile of V_TILE state columns) walks the chunks in a
//     loop and keeps its (K, V_TILE) state tile in shared memory.  Column v of
//     y and of S' reads only column v of S, so the V split is exact with no
//     second pass; it costs recomputing the C x C scores in each of the K /
//     V_TILE blocks of a head, and buys K / V_TILE times the blocks (a 32-token
//     prefill chunk at B = 1, H = 32, K = 64: 128 blocks for 132 SMs, not 32);
//   * the (C, C, K) pairwise decay tensor is never built (256 KB at C = 32,
//     K = 64): each score of the lower triangle (diagonal included, which
//     carries the bonus u) is a K-long dot whose decay factor is computed on
//     the fly; the strictly upper triangle is skipped, not computed and zeroed;
//   * each chunk's r, k, w, L, Lp (C x K) and v (C x V_TILE) are staged in
//     shared memory as fp32 (52 KB at C = 32, K = 64: dynamic shared memory,
//     opted in with cudaFuncSetAttribute); the cumsum runs along time in fp32.
//
// Bound: memory.  A call must read r, k, v, w and s0 once and write y and sT
// once: at a 32-token prefill chunk (B = 1, H = 32, K = 64, bf16 r/k/v/y) about
// 1.84 MB, 0.55 us at 3.35 TB/s.  The exp work (about 34 K per block and chunk,
// 4.3 M for that call with the V split) is far under the SFU's rate.  This
// first version is plain fp32 FMA loops, no tensor cores and no TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kClip = -60.f;

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

size_t smem_bytes(int C, int K, int vt) {
  const size_t ld = (size_t)K + 1;            // padded row stride: no bank conflicts
  const size_t floats = 5 * (size_t)C * ld    // r, k (-> k_sc), w (-> r_dec), L, Lp
                        + (size_t)C * vt      // v tile
                        + (size_t)C * (C + 1) // scores
                        + (size_t)K * vt      // state tile
                        + (size_t)K;          // u
  return floats * sizeof(float);
}

// Row t and column j of the lower triangle (diagonal included) at linear index p.
__device__ __forceinline__ void tri_index(int p, int& t, int& j) {
  int r = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= p) ++r;
  while (r * (r + 1) / 2 > p) --r;
  t = r;
  j = p - r * (r + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT,
            int T_len, int H, int K, int C, int vt) {
  extern __shared__ float smem[];
  const int ld = K + 1;
  float* r_s = smem;                  // (C, ld)
  float* k_s = r_s + C * ld;          // (C, ld) k, then k * exp(L_last - L)
  float* w_s = k_s + C * ld;          // (C, ld) w, then r * exp(Lp)
  float* L_s = w_s + C * ld;          // (C, ld) inclusive cumsum
  float* Lp_s = L_s + C * ld;         // (C, ld) exclusive
  float* v_s = Lp_s + C * ld;         // (C, vt)
  float* sc_s = v_s + C * vt;         // (C, C + 1)
  float* S_s = sc_s + C * (C + 1);    // (K, vt)
  float* u_s = S_s + K * vt;          // (K)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * vt;
  const int tid = threadIdx.x;
  constexpr int kVec = 16 / sizeof(T);
  const int row_stride = H * K;                       // elements between steps
  const size_t head_off = (size_t)b * T_len * row_stride + (size_t)h * K;
  const float* s_in = s0 + (size_t)bh * K * K;

  for (int i = tid; i < K * vt; i += blockDim.x) {
    const int kk = i / vt, c = i % vt;
    S_s[i] = s_in[(size_t)kk * K + v0 + c];
  }
  for (int i = tid; i < K; i += blockDim.x) u_s[i] = u[(size_t)h * K + i];

  const int n_chunks = (T_len + C - 1) / C;
  const int kv_vecs = K / kVec;
  const int vt_vecs = vt / kVec;
  const int n_pairs = C * (C + 1) / 2;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * C;
    const int nvalid = min(C, T_len - t0);
    __syncthreads();  // the previous chunk's readers are done with every buffer

    // ---- stage r, k, w (all K) and v (this block's columns) as fp32 ----
    for (int c = tid; c < C * kv_vecs; c += blockDim.x) {
      const int t = c / kv_vecs, d0 = (c % kv_vecs) * kVec;
      float* rd = r_s + t * ld + d0;
      float* kd = k_s + t * ld + d0;
      float* wd = w_s + t * ld + d0;
      if (t < nvalid) {
        const size_t off = head_off + (size_t)(t0 + t) * row_stride + d0;
        float tmp[kVec];
        load_vec(r + off, tmp);
#pragma unroll
        for (int i = 0; i < kVec; ++i) rd[i] = tmp[i];
        load_vec(k + off, tmp);
#pragma unroll
        for (int i = 0; i < kVec; ++i) kd[i] = tmp[i];
#pragma unroll
        for (int i = 0; i < kVec; i += 4) load_vec(w + off + i, wd + i);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) { rd[i] = 0.f; kd[i] = 0.f; wd[i] = 0.f; }
      }
    }
    for (int c = tid; c < C * vt_vecs; c += blockDim.x) {
      const int t = c / vt_vecs, d0 = (c % vt_vecs) * kVec;
      float* vd = v_s + t * vt + d0;
      if (t < nvalid) {
        load_vec(v + head_off + (size_t)(t0 + t) * row_stride + v0 + d0, vd);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) vd[i] = 0.f;
      }
    }
    __syncthreads();

    // ---- cumulative log-decay along time; r_dec = r * exp(Lp) into w_s ----
    for (int kk = tid; kk < K; kk += blockDim.x) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float wv = w_s[t * ld + kk];
        acc += wv;
        const float lp = acc - wv;
        L_s[t * ld + kk] = acc;
        Lp_s[t * ld + kk] = lp;
        w_s[t * ld + kk] = r_s[t * ld + kk] * expf(lp);
      }
    }
    __syncthreads();

    // ---- scores over the lower triangle: decay on the fly, bonus on the diagonal ----
    for (int p = tid; p < n_pairs; p += blockDim.x) {
      int t, j;
      tri_index(p, t, j);
      const float* rt = r_s + t * ld;
      const float* kj = k_s + j * ld;
      float acc = 0.f;
      if (j < t) {
        const float* lpt = Lp_s + t * ld;
        const float* lj = L_s + j * ld;
        for (int kk = 0; kk < K; ++kk) {
          const float dlog = fminf(fmaxf(lpt[kk] - lj[kk], kClip), 0.f);
          acc = fmaf(rt[kk] * kj[kk], expf(dlog), acc);
        }
      } else {
        for (int kk = 0; kk < K; ++kk) acc = fmaf(rt[kk] * u_s[kk], kj[kk], acc);
      }
      sc_s[t * (C + 1) + j] = acc;
    }
    __syncthreads();

    // ---- y = r_dec @ S + scores @ v, for this block's columns ----
    for (int i = tid; i < nvalid * vt; i += blockDim.x) {
      const int t = i / vt, c = i % vt;
      const float* rd = w_s + t * ld;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc = fmaf(rd[kk], S_s[kk * vt + c], acc);
      const float* st = sc_s + t * (C + 1);
      for (int j = 0; j <= t; ++j) acc = fmaf(st[j], v_s[j * vt + c], acc);
      store_out(y + head_off + (size_t)(t0 + t) * row_stride + v0 + c, acc);
    }
    // k_sc = k * exp(L_last - L): k_s is free once the scores are done
    for (int i = tid; i < C * K; i += blockDim.x) {
      const int t = i / K, kk = i % K;
      k_s[t * ld + kk] *= expf(L_s[(C - 1) * ld + kk] - L_s[t * ld + kk]);
    }
    __syncthreads();

    // ---- S' = exp(L_last) * S + k_sc^T @ v ----
    for (int i = tid; i < K * vt; i += blockDim.x) {
      const int kk = i / vt, c = i % vt;
      float acc = expf(L_s[(C - 1) * ld + kk]) * S_s[i];
      for (int t = 0; t < C; ++t) acc = fmaf(k_s[t * ld + kk], v_s[t * vt + c], acc);
      S_s[i] = acc;
    }
  }
  __syncthreads();

  float* s_out = sT + (size_t)bh * K * K;
  for (int i = tid; i < K * vt; i += blockDim.x) {
    const int kk = i / vt, c = i % vt;
    s_out[(size_t)kk * K + v0 + c] = S_s[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* sT, int B, int T_len, int H, int K, int C,
           int vt, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (B <= 0 || T_len <= 0 || H <= 0 || K <= 0 || C <= 0 || C > T_len || vt <= 0 ||
      K % vt || K % kVec || vt % kVec)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C, K, vt);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, K / vt);
  wkv6_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(sT),
      T_len, H, K, C, vt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wkv6_f32(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* y, void* sT, int B, int T, int H, int K, int chunk,
             int v_tile, void* stream) {
  return launch<float>(r, k, v, w, u, s0, y, sT, B, T, H, K, chunk, v_tile, stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const void* w, const void* u,
              const void* s0, void* y, void* sT, int B, int T, int H, int K, int chunk,
              int v_tile, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T, H, K, chunk, v_tile,
                               stream);
}

unsigned long long wkv6_smem_bytes(int chunk, int K, int v_tile) {
  return (unsigned long long)smem_bytes(chunk, K, v_tile);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
