// Flash attention forward for GQA on Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel): causal / sliding-window / bidirectional attention with
// right-aligned queries, fp32 scores and an fp32 online softmax.
//
// Contract (the same as the plain PyTorch version, flash_attention_ref):
//   q    (B, S, h, hd)   T   contiguous
//   k    (B, T, hk, hd)  T   batch and sequence strides as given (the slab
//                            path passes k[:, :valid] of a (B, max_len, hk, hd)
//                            cache: nothing is copied), head stride hd, unit
//                            dim stride
//   v    (B, T, hk, hdv) T   as k, head stride hdv
//   out  (B, S, h, hdv)  T   contiguous
//   lse  (B, h, S)   fp32    or null: each row's natural-log log-sum-exp of
//                            its scaled scores over the keys it sees (the
//                            training forward asks for it; the backward,
//                            csrc/flash_attention_bwd.cu, recomputes P from
//                            it); the output is the same bit for bit either way
// (hd, hdv) is (64, 64), (128, 128) or MLA's (192, 128): nope 128 + rope 64
// for q and k, 128 for v (its train and prefill branch).
// Query s sits at position s + T - S.  Key t is visible to it iff t <= pos
// (when causal) and t > pos - window (when window > 0).  Query head i reads KV
// head i / (h / hk).  Scores are scaled by `scale` (1/sqrt(hd), q's width)
// after the dot.
//
// bf16 (the path serving runs): the shared tensor-core core of
// gqa_attention.cuh with SlabPolicy below -- key row t of slot b at
// k + b * k_bs + t * k_ss, query row positions right-aligned.  The wrapper's
// plan: a slab prefill runs 512 blocks of one warpgroup (128 rows, wgmma
// products, 64-key cp.async tiles); a decode step runs one-warp blocks
// (16 rows, mma.sync) with the keys split over a thread-block cluster.  Masks
// only on the diagonal and window-edge tiles.  Bound: memory at the slab
// path's shapes (q, k, v read once, out written once); a long prefill comes
// near the tensor cores' bound.
//
// fp32: the first version's FMA kernel below, and never TF32: the
// card-vs-CPU greedy parity of the fp32 serving runs (2e-5 bar) rests on it.
// One block of 256 threads per (b, kv head, tile of RT query rows), rows taken
// position-major across the g = h / hk heads of the group; key tiles of 64
// staged in shared memory as fp32 (K transposed, V row-major), walking only the
// tiles some row can see; thread (ty, tx) of the 16 x 16 grid owns RPT rows and
// keeps an RPT x 4 score tile, the rows' (m, l) and output columns in
// registers; the probabilities pass through shared memory to the value
// product.  RPT is 4 (64 rows a block) for prefill and 1 (16 rows) for
// decode-sized calls.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "gqa_attention.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // running-max floor: exp(m_prev - m_new) stays finite
constexpr int kThreads = 256;       // a 16 x 16 grid of (ty, tx)
constexpr int kKT = 64;             // keys per staged tile: 16 lanes x 4 keys

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

// max / sum over the 16 lanes of a half-warp (one ty)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int hd, int hdv, int rt) {
  // q (hd x rt, transposed) + K tile (hd x 64, transposed; later the
  // probabilities, rt x 64) + V tile (64 x hdv)
  return ((size_t)hd * rt + (size_t)hd * kKT + (size_t)kKT * hdv) * sizeof(float);
}

// HD: q's and K's width; HDV: V's and the output's
template <typename T, int HD, int HDV, int RPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tk,
                 int h, int hk, long long k_bs, long long k_ss, long long v_bs,
                 long long v_ss, int causal, int window, float scale) {
  constexpr int RT = 16 * RPT;       // query rows a block
  constexpr int NC = HDV / 64;       // 4-wide output column groups a thread
  constexpr int kVec = 16 / sizeof(T);
  constexpr int VPR = HD / kVec;     // 16-byte vectors a q or K row
  constexpr int VPRV = HDV / kVec;   // ... a V row
  static_assert(RT <= HD, "the probabilities fit the K tile");
  extern __shared__ float smem[];
  float* q_s = smem;                 // [HD][RT]
  float* k_s = q_s + HD * RT;        // [HD][kKT]; then p [RT][kKT]
  float* v_s = k_s + HD * kKT;       // [kKT][HDV]
  float* p_s = k_s;

  const int b = blockIdx.x / hk;
  const int kvh = blockIdx.x % hk;
  const int g = h / hk;
  const int rows = g * S;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, rows - r0);
  const int off = Tk - S;            // right alignment
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;

  // stage q transposed: row r of the tile is (position (r0+r) / g, member (r0+r) % g)
  for (int c = tid; c < RT * VPR; c += kThreads) {
    const int r = c % RT, d0 = (c / RT) * kVec;
    float tmp[kVec];
    if (r < nr) {
      const int row = r0 + r, s = row / g, head = kvh * g + row % g;
      load_vec(q + (((size_t)b * S + s) * h + head) * HD + d0, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) q_s[(d0 + e) * RT + r] = tmp[e];
  }

  // this thread's rows and their positions; the warp's (two ty) range
  int qpos[RPT];
  bool valid[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    valid[i] = r < nr;
    qpos[i] = (r0 + r) / g + off;
  }
  const int wr_lo = warp * 2 * RPT;                     // first tile row of the warp
  const bool warp_live = wr_lo < nr;
  const int wr_hi = min(nr, wr_lo + 2 * RPT) - 1;
  const int wq_lo = (r0 + wr_lo) / g + off;
  const int wq_hi = (r0 + max(wr_hi, wr_lo)) / g + off;

  // key range some row of the block can see
  const int bq_lo = r0 / g + off;
  const int bq_hi = (r0 + nr - 1) / g + off;
  const int k_hi = causal ? min(Tk - 1, bq_hi) : Tk - 1;
  const int k_lo = window > 0 ? max(0, bq_lo - window + 1) : 0;

  float m[RPT], l[RPT], acc[RPT][4 * NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = (k_lo / kKT) * kKT; t0 <= k_hi; t0 += kKT) {
    __syncthreads();  // the previous tile's readers are done with k_s / p_s / v_s
    // K transposed: a warp covers 32 consecutive keys of one 16-byte column slice
    for (int c = tid; c < kKT * VPR; c += kThreads) {
      const int t = c % kKT, d0 = (c / kKT) * kVec;
      const int kp = t0 + t;
      float tmp[kVec];
      if (kp < Tk) {
        load_vec(k + (size_t)b * k_bs + (size_t)kp * k_ss + (size_t)kvh * HD + d0, tmp);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) tmp[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) k_s[(d0 + e) * kKT + t] = tmp[e];
    }
    // V row-major: consecutive threads on consecutive 16-byte slices of a row
    for (int c = tid; c < kKT * VPRV; c += kThreads) {
      const int t = c / VPRV, d0 = (c % VPRV) * kVec;
      const int kp = t0 + t;
      float* dst = v_s + t * HDV + d0;
      if (kp < Tk) {
        load_vec(v + (size_t)b * v_bs + (size_t)kp * v_ss + (size_t)kvh * HDV + d0, dst);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
      }
    }
    __syncthreads();

    // does some row of this warp see a key of the tile?  (warp-uniform)
    bool live = warp_live && t0 < Tk;
    if (causal) live = live && t0 <= wq_hi;
    if (window > 0) live = live && t0 + kKT - 1 > wq_lo - window;

    float sc[RPT][4];
    if (live) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + d * kKT + tx * 4);
        float qv[RPT];
        if constexpr (RPT == 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(q_s + d * RT + ty * 4);
          qv[0] = q4.x; qv[1] = q4.y; qv[2] = q4.z; qv[3] = q4.w;
        } else {
          qv[0] = q_s[d * RT + ty];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          sc[i][0] = fmaf(qv[i], kv.x, sc[i][0]);
          sc[i][1] = fmaf(qv[i], kv.y, sc[i][1]);
          sc[i][2] = fmaf(qv[i], kv.z, sc[i][2]);
          sc[i][3] = fmaf(qv[i], kv.w, sc[i][3]);
        }
      }
      // mask, then the online-softmax update of each row
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = t0 + tx * 4 + j;
          bool vis = valid[i] && kp < Tk;
          if (causal) vis = vis && kp <= qpos[i];
          if (window > 0) vis = vis && kp > qpos[i] - window;
          sc[i][j] = vis ? sc[i][j] * scale : -INFINITY;
          mx = fmaxf(mx, sc[i][j]);
        }
        mx = half_warp_max(mx);
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = expf(sc[i][j] - m_new);   // masked: exp(-inf) = 0
          sum += sc[i][j];
        }
        sum = half_warp_sum(sum);
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
      }
    }
    __syncthreads();  // every warp is done reading the K tile
    if (live) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        *reinterpret_cast<float4*>(p_s + (ty * RPT + i) * kKT + tx * 4) =
            make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < kKT; t += 4) {
        float4 pr[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          pr[i] = *reinterpret_cast<const float4*>(p_s + (ty * RPT + i) * kKT + t);
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 vv =
                *reinterpret_cast<const float4*>(v_s + (t + tt) * HDV + c * 64 + tx * 4);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float p = tt == 0 ? pr[i].x : tt == 1 ? pr[i].y
                            : tt == 2 ? pr[i].z : pr[i].w;
              acc[i][c * 4 + 0] = fmaf(p, vv.x, acc[i][c * 4 + 0]);
              acc[i][c * 4 + 1] = fmaf(p, vv.y, acc[i][c * 4 + 1]);
              acc[i][c * 4 + 2] = fmaf(p, vv.z, acc[i][c * 4 + 2]);
              acc[i][c * 4 + 3] = fmaf(p, vv.w, acc[i][c * 4 + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!valid[i]) continue;
    const int row = r0 + ty * RPT + i, s = row / g, head = kvh * g + row % g;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (lse != nullptr && tx == 0) lse[((size_t)b * h + head) * S + s] = m[i] + logf(l[i]);
    T* o = out + (((size_t)b * S + s) * h + head) * HDV;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out(o + c * 64 + tx * 4 + e, acc[i][c * 4 + e] * inv);
  }
}

template <typename T, int HD, int HDV, int RPT>
int launch_one(const void* q, const void* k, const void* v, void* out, float* lse,
               int B, int S,
               int Tk, int h, int hk, long long k_bs, long long k_ss, long long v_bs,
               long long v_ss, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, HDV, 16 * RPT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD, HDV, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = (h / hk) * S;
  const int rt = 16 * RPT;
  const dim3 grid(B * hk, (rows + rt - 1) / rt);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, HD, HDV, RPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, Tk, h, hk, k_bs, k_ss, v_bs, v_ss, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
           int S, int Tk, int h, int hk, int hd, int hdv, long long k_bs, long long k_ss,
           long long v_bs, long long v_ss, int causal, int window,
           int rows_per_thread, float scale, void* stream_ptr) {
  if (B <= 0 || S <= 0 || Tk <= 0 || hk <= 0 || h % hk)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define FLASH_ARGS q, k, v, out, lse, B, S, Tk, h, hk, k_bs, k_ss, v_bs, v_ss, causal, \
                   window, scale, stream
  if (hd == 64 && hdv == 64 && rows_per_thread == 4) return launch_one<T, 64, 64, 4>(FLASH_ARGS);
  if (hd == 64 && hdv == 64 && rows_per_thread == 1) return launch_one<T, 64, 64, 1>(FLASH_ARGS);
  if (hd == 128 && hdv == 128 && rows_per_thread == 4)
    return launch_one<T, 128, 128, 4>(FLASH_ARGS);
  if (hd == 128 && hdv == 128 && rows_per_thread == 1)
    return launch_one<T, 128, 128, 1>(FLASH_ARGS);
  if (hd == 192 && hdv == 128 && rows_per_thread == 4)
    return launch_one<T, 192, 128, 4>(FLASH_ARGS);
  if (hd == 192 && hdv == 128 && rows_per_thread == 1)
    return launch_one<T, 192, 128, 1>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// bf16: where the core finds key row t (a strided slab) and the query rows'
// positions (right-aligned: row r of the tile is query (r0 + r) / g)
template <int HD, int HDV>
struct SlabPolicy {
  static constexpr int kHD = HD;
  static constexpr int kHDV = HDV;
  static constexpr bool kPrepare = false;
  const gqa::bf16* k;
  const gqa::bf16* v;
  float* lse;                            // (B, h, S) or null
  long long k_bs, k_ss, v_bs, v_ss;
  int Tk, causal, window;
  int off, g, r0, nr;                    // set by begin()

  __device__ void begin(int b, int kvh, int r0_, int nr_, int g_, int S, unsigned char*) {
    k += b * k_bs + kvh * HD;
    v += b * v_bs + kvh * HDV;
    off = Tk - S;
    g = g_;
    r0 = r0_;
    nr = nr_;
  }
  __device__ int qpos(int r) const { return (r0 + r) / g + off; }
  __device__ void key_range(int& lo, int& hi) const {
    const int q_lo = r0 / g + off, q_hi = (r0 + nr - 1) / g + off;
    hi = causal ? min(Tk - 1, q_hi) : Tk - 1;
    lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  }
  __device__ int key_limit() const { return Tk; }
  __device__ void prepare(int, int, int) {}
  __device__ const gqa::bf16* k_row(int, int kpos) const { return k + kpos * k_ss; }
  __device__ const gqa::bf16* v_row(int, int kpos) const { return v + kpos * v_ss; }
};

template <int HD, int HDV>
int launch_bf16_hd(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int S, int Tk, int h, int hk, long long k_bs, long long k_ss,
                   long long v_bs, long long v_ss, int causal, int window, int warps,
                   int splits, float scale, cudaStream_t stream) {
  SlabPolicy<HD, HDV> pol{};
  pol.k = static_cast<const gqa::bf16*>(k);
  pol.v = static_cast<const gqa::bf16*>(v);
  pol.lse = lse;
  pol.k_bs = k_bs; pol.k_ss = k_ss; pol.v_bs = v_bs; pol.v_ss = v_ss;
  pol.Tk = Tk; pol.causal = causal; pol.window = window;
  if (warps == 4)
    return gqa::launch<4>(pol, q, out, B, S, h, hk, splits, scale, 0, stream);
  if (warps == 1)
    return gqa::launch<1>(pol, q, out, B, S, h, hk, splits, scale, 0, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int S, int Tk, int h, int hk, int hd, int hdv, long long k_bs,
                        long long k_ss, long long v_bs, long long v_ss, int causal,
                        int window, int rows_per_thread, float scale, void* stream) {
  return launch<float>(q, k, v, out, static_cast<float*>(lse), B, S, Tk, h, hk, hd, hdv, k_bs, k_ss, v_bs, v_ss,
                       causal, window, rows_per_thread, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                         int B, int S, int Tk, int h, int hk, int hd, int hdv, long long k_bs,
                         long long k_ss, long long v_bs, long long v_ss, int causal,
                         int window, int warps, int splits, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || hk <= 0 || h % hk)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, out, static_cast<float*>(lse), B, S, Tk, h, hk, k_bs, k_ss, \
                   v_bs, v_ss, causal, window, warps, splits, scale, st
  if (hd == 64 && hdv == 64) return launch_bf16_hd<64, 64>(FLASH_ARGS);
  if (hd == 128 && hdv == 128) return launch_bf16_hd<128, 128>(FLASH_ARGS);
  if (hd == 192 && hdv == 128) return launch_bf16_hd<192, 128>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

unsigned long long flash_attention_smem_bytes(int hd, int hdv, int rows_per_thread) {
  return (unsigned long long)smem_bytes(hd, hdv, 16 * rows_per_thread);
}

unsigned long long flash_attention_bf16_smem_bytes(int hd, int hdv, int warps) {
  return (unsigned long long)(warps == 4 ? gqa::core_smem_bytes<4>(hd, hdv)
                                         : gqa::core_smem_bytes<1>(hd, hdv));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
