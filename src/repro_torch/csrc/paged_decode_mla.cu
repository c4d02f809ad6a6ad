// Absorbed-MLA paged flash-decode on Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel repro/kernels/paged_decode.py::paged_flash_decode_mla
// (body _mla_kernel).  DeepSeek-V3's multi-head latent attention caches one
// compressed latent per token instead of per-head K/V, and the decode attends
// in that latent space: every query head reads the same latent rows.  The
// kernel fuses the page-table gather into an fp32 online softmax, so the
// slot-major gather of the pool never exists in device memory.
//
// Contract (the same as the plain PyTorch version, paged_read followed by the
// reference's XLA formula):
//   q_lat   (B, S, h, r)    T       q_nope projected into the latent by w_uk
//   q_rope  (B, S, h, rope) T       rotated rope part of the queries
//   ckv     (N, r)          T       token-major latent pool, N = pages * page_size
//   krope   (N, rope)       T       token-major rope-key pool (one shared head)
//   table   (B, W)          int32   physical page of each logical block, 0 = trash
//   pos     (B, S)          int32   logical position of each query
//   out     (B, S, h, r)    T       softmax(scale (q_lat.ckv + q_rope.krope)) @ ckv
// Key t is visible to query (b, s) iff t <= pos[b, s] (and t > pos[b, s] - window
// when window > 0).  The value is the latent ckv itself.
//
// Design: the TPU kernel holds all h*S query rows of a slot in one grid step's
// scratch (rows x r fp32: 8 MiB at a 32-token chunk of 128 heads), far beyond a
// block's 227 KB of shared memory.  Here the rows are laid out head-major (row
// i = head * S + s, its position pos[b, i % S]) and cut into tiles of ROWS:
// one block per (slot, row tile), a grid of B x ceil(h*S / ROWS), with ROWS
// 16, or 8 where 16 would leave SMs idle (decode: 8 slots x 128 heads).  A block
// stages its q rows as fp32, reads its table row and positions itself, and
// walks only the keys in [min_pos - window + 1, max_pos] of its rows in tiles
// of kKeys latent rows (plus their rope rows).  The tiles are copied into
// shared memory in the input type with cp.async, double-buffered: the next
// tile's copy is in flight while the block computes on this one, so the page
// walk's load latency hides behind the products.  For a tile, each warp
// scores kKeysPerWarp keys against every row (lanes split the r + rope dot; a
// transposing shuffle sum closes the four keys' dots in 6 shuffles), one warp
// per row updates the row's (m, l) online-softmax state, and each thread owns
// two latent columns of the ROWS x r accumulator in registers for the value
// product.  Masked scores are -inf, so they leave (m, l, acc) untouched:
// pages the mask kills -- the trash page, unallocated blocks, the unwritten
// tail of the last page -- never reach the output, and a row with no visible
// key outputs 0.
//
// Bound: operations.  A call reads each visible latent row once (r + rope
// values a token) but does 2 (2 r + rope) flops per (query row, visible key):
// at 128 heads that is far above the card's bytes-to-flops balance.  This first
// version runs both products as fp32 FMAs on the CUDA cores (no tensor cores),
// so it sits well above the tensor-core bound; at decode all blocks of a slot
// re-read the slot's pages, which L2 serves.  Shared memory: the q rows (36 KB
// at r 512, rope 64, 16 rows) and two key tiles (72 KB in bf16, 144 KB in
// fp32); with at most 128 registers a thread, two bf16 blocks share an SM, so
// a 32-token chunk's 256 blocks run in one wave.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;   // running-max floor: exp(m_prev - m_new) stays finite
constexpr int kThreads = 256;       // 8 warps
constexpr int kMaxRows = 16;        // query rows per block: 16, or 8 when 16 leave SMs idle
constexpr int kKeysPerWarp = 4;
constexpr int kKeys = (kThreads / 32) * kKeysPerWarp;   // latent rows per tile
constexpr int kMaxR = 512;          // latent width: 4 float4 per lane, 2 columns a thread
constexpr int kMaxRope = 64;        // rope width: 2 values per lane

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

// four consecutive values of a staged row, as fp32 (8 or 16 bytes aligned)
__device__ __forceinline__ void load4(const float* src, float* dst) {
  load_vec(src, dst);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* dst) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}

__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
size_t smem_bytes(int rows, int r, int rope) {
  const size_t floats = (size_t)rows * (r + rope)    // q rows (latent, rope)
                        + (size_t)rows * kKeys       // scores / probabilities
                        + 3 * (size_t)rows;          // m, l, alpha
  return floats * sizeof(float) + (size_t)rows * sizeof(int)
         + 2 * (size_t)kKeys * (r + rope) * sizeof(T);  // two key tiles
}

// Stage the q rows of the block as fp32: row i of the tile is query row
// r0 + i of the head-major layout; rows past nr stay zero.
template <int ROWS, typename T>
__device__ __forceinline__ void stage_q(const T* __restrict__ q_lat,
                                        const T* __restrict__ q_rope, int b,
                                        int S, int h, int r, int rope, int r0,
                                        int nr, float* ql_s, float* qr_s) {
  constexpr int kVec = 16 / sizeof(T);
  const int vr = r / kVec, vrow = vr + rope / kVec;
  for (int c = threadIdx.x; c < ROWS * vrow; c += blockDim.x) {
    const int i = c / vrow, j = c % vrow;
    const bool is_lat = j < vr;
    float* dst = is_lat ? ql_s + i * r + j * kVec
                        : qr_s + i * rope + (j - vr) * kVec;
    if (i < nr) {
      const int row = r0 + i;
      const size_t tok = ((size_t)b * S + row % S) * h + row / S;
      if (is_lat) load_vec(q_lat + tok * r + j * kVec, dst);
      else load_vec(q_rope + tok * rope + (j - vr) * kVec, dst);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
    }
  }
}

// Issue the copies of keys k0 .. k0 + kKeys - 1 of slot b (latent rows into
// c_t, rope rows into kr_t, in the input type) and commit them as one group.
// Keys past hi are zero-filled: their probability is exactly 0, and 0 times
// the stale contents of shared memory could be NaN.
template <typename T>
__device__ __forceinline__ void issue_tile(const T* __restrict__ ckv,
                                           const T* __restrict__ krope,
                                           const int* __restrict__ table, int b,
                                           int W, int ps, int r, int rope,
                                           int k0, int hi, T* c_t, T* kr_t) {
  constexpr int kVec = 16 / sizeof(T);
  const int vr = r / kVec, vrow = vr + rope / kVec;
  const int lane = threadIdx.x & 31;
  // one warp per key row, its lanes over the row's 16-byte chunks: the page
  // lookup is made once a key, and no chunk index is divided
  for (int t = threadIdx.x >> 5; t < kKeys; t += blockDim.x >> 5) {
    const int kp = k0 + t;
    const bool live = kp <= hi;
    const size_t tok = live ? (size_t)table[b * W + kp / ps] * ps + kp % ps : 0;
    for (int j = lane; j < vrow; j += 32) {
      const bool is_lat = j < vr;
      T* dst = is_lat ? c_t + t * r + j * kVec
                      : kr_t + t * rope + (j - vr) * kVec;
      if (live) {
        cp_async16(dst, is_lat ? ckv + tok * r + j * kVec
                               : krope + tok * rope + (j - vr) * kVec);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  cp_async_commit();
}

// Sum four values over the warp: returns, in lane l, the full sum of value
// ((l >> 4) & 1) * 2 + ((l >> 3) & 1) -- 6 shuffles instead of 4 x 5.
__device__ __forceinline__ float warp_sum4(const float (&v)[4], int lane) {
  const bool up16 = lane & 16;
  float k0 = up16 ? v[2] : v[0], k1 = up16 ? v[3] : v[1];
  const float s0 = up16 ? v[0] : v[2], s1 = up16 ? v[1] : v[3];
  k0 += __shfl_xor_sync(0xffffffffu, s0, 16);
  k1 += __shfl_xor_sync(0xffffffffu, s1, 16);
  const bool up8 = lane & 8;
  float k = up8 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, up8 ? k0 : k1, 8);
  k += __shfl_xor_sync(0xffffffffu, k, 4);
  k += __shfl_xor_sync(0xffffffffu, k, 2);
  k += __shfl_xor_sync(0xffffffffu, k, 1);
  return k;
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads, 2)
paged_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                 const T* __restrict__ ckv, const T* __restrict__ krope,
                 const int* __restrict__ table, const int* __restrict__ qpos,
                 T* __restrict__ out, int S, int h, int r, int rope, int W,
                 int ps, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ql_s = smem;                        // ROWS x r
  float* qr_s = ql_s + ROWS * r;            // ROWS x rope
  float* p_s = qr_s + ROWS * rope;          // ROWS x kKeys
  float* m_s = p_s + ROWS * kKeys;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  int* qp_s = reinterpret_cast<int*>(a_s + ROWS);
  T* tiles = reinterpret_cast<T*>(qp_s + ROWS);   // 2 x (kKeys x (r + rope))
  const int tile_elems = kKeys * (r + rope);

  static_assert(ROWS % 4 == 0 && ROWS <= kMaxRows && kKeysPerWarp == 4,
                "16-byte aligned p_s rows; warp_sum4 closes four dots");
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, h * S - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Rows past nr stay zero and fully masked (position -1).
  if (tid < ROWS) {
    qp_s[tid] = tid < nr ? qpos[b * S + (r0 + tid) % S] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  stage_q<ROWS>(q_lat, q_rope, b, S, h, r, rope, r0, nr, ql_s, qr_s);
  __syncthreads();

  int maxpos = -1, minpos = INT_MAX;
  for (int i = 0; i < nr; ++i) {
    maxpos = max(maxpos, qp_s[i]);
    minpos = min(minpos, qp_s[i]);
  }
  // Keys any row of the block can see: [lo, hi].  Past hi every key is beyond
  // every query (unwritten or trash); before lo the window kills it.
  const int hi = maxpos < 0 ? -1 : min(W * ps - 1, maxpos);
  const int lo = window > 0 ? max(0, minpos - window + 1) : 0;

  const int c0 = 2 * tid;                    // this thread's latent columns
  const bool owns = c0 < r;
  float acc[ROWS][2];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i][0] = acc[i][1] = 0.f;

  if (lo <= hi)
    issue_tile(ckv, krope, table, b, W, ps, r, rope, lo, hi, tiles,
               tiles + kKeys * r);
  for (int k0 = lo, buf = 0; k0 <= hi; k0 += kKeys, buf ^= 1) {
    // prefetch the next tile into the other buffer (an empty group at the
    // end), then wait for this one; the barrier at the end of the previous
    // iteration freed the other buffer
    T* nxt = tiles + (buf ^ 1) * tile_elems;
    if (k0 + kKeys <= hi)
      issue_tile(ckv, krope, table, b, W, ps, r, rope, k0 + kKeys, hi, nxt,
                 nxt + kKeys * r);
    else
      cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const T* c_t = tiles + buf * tile_elems;   // kKeys x r
    const T* kr_t = c_t + kKeys * r;           // kKeys x rope

    // scores: warp w scores keys w*kKeysPerWarp.. against every row; each
    // lane holds its slice (latent dims lane*4 + 128 j, rope dims lane + 32 j)
    {
      float kl[kKeysPerWarp][kMaxR / 32];
      float kr[kKeysPerWarp][kMaxRope / 32];
#pragma unroll
      for (int u = 0; u < kKeysPerWarp; ++u) {
        const int t = warp * kKeysPerWarp + u;
#pragma unroll
        for (int j = 0; j < kMaxR / 128; ++j) {
          const int d = lane * 4 + 128 * j;
          if (d < r) {
            load4(c_t + t * r + d, &kl[u][4 * j]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) kl[u][4 * j + e] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxRope / 32; ++j) {
          const int d = lane + 32 * j;
          kr[u][j] = d < rope ? to_f32(kr_t[t * rope + d]) : 0.f;
        }
      }
      // the key this lane reports after warp_sum4, and its visibility
      const int t_mine = warp * kKeysPerWarp + ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
      const int kp_mine = k0 + t_mine;
#pragma unroll 2
      for (int i = 0; i < ROWS; ++i) {
        float ql[kMaxR / 32], qr[kMaxRope / 32];
#pragma unroll
        for (int j = 0; j < kMaxR / 128; ++j) {
          const int d = lane * 4 + 128 * j;
          if (d < r) {
            load_vec(ql_s + i * r + d, &ql[4 * j]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) ql[4 * j + e] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxRope / 32; ++j) {
          const int d = lane + 32 * j;
          qr[j] = d < rope ? qr_s[i * rope + d] : 0.f;
        }
        float part[kKeysPerWarp];
#pragma unroll
        for (int u = 0; u < kKeysPerWarp; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kMaxR / 32; ++e) dot = fmaf(ql[e], kl[u][e], dot);
#pragma unroll
          for (int e = 0; e < kMaxRope / 32; ++e) dot = fmaf(qr[e], kr[u][e], dot);
          part[u] = dot;
        }
        const float dot = warp_sum4(part, lane);
        if ((lane & 7) == 0) {
          const int qp = qp_s[i];
          const bool vis = kp_mine <= hi && kp_mine <= qp &&
                           (window <= 0 || kp_mine > qp - window);
          p_s[i * kKeys + t_mine] = vis ? dot * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online-softmax update, one warp per row, one lane per key
    for (int i = warp; i < ROWS; i += kThreads / 32) {
      const float sc = p_s[i * kKeys + lane];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float e = expf(sc - m_new);      // masked: exp(-inf) = 0
      p_s[i * kKeys + lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

    // value product: acc (ROWS x r) += p (ROWS x kKeys) @ latent tile
    if (owns) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float a = a_s[i];
        acc[i][0] *= a;
        acc[i][1] *= a;
      }
      for (int t = 0; t < kKeys; t += 4) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = load2(c_t + (t + u) * r + c0);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + i * kKeys + t);
          acc[i][0] = fmaf(p.x, v[0].x, acc[i][0]);
          acc[i][1] = fmaf(p.x, v[0].y, acc[i][1]);
          acc[i][0] = fmaf(p.y, v[1].x, acc[i][0]);
          acc[i][1] = fmaf(p.y, v[1].y, acc[i][1]);
          acc[i][0] = fmaf(p.z, v[2].x, acc[i][0]);
          acc[i][1] = fmaf(p.z, v[2].y, acc[i][1]);
          acc[i][0] = fmaf(p.w, v[3].x, acc[i][0]);
          acc[i][1] = fmaf(p.w, v[3].y, acc[i][1]);
        }
      }
    }
    __syncthreads();  // this tile's buffer and p_s are free for the next copies
  }

  // l_s was last written before the barrier that precedes the value product
  if (owns) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < nr) {
        const int row = r0 + i;
        float l = l_s[i];
        l = l == 0.f ? 1.f : l;              // a fully masked row outputs 0
        store2(out + (((size_t)b * S + row % S) * h + row / S) * r + c0,
               acc[i][0] / l, acc[i][1] / l);
      }
    }
  }
}

template <typename T, int ROWS>
int run(const void* q_lat, const void* q_rope, const void* ckv,
        const void* krope, const void* table, const void* qpos, void* out, int B,
        int S, int h, int r, int rope, int W, int ps, int window, float scale,
        void* stream) {
  const size_t smem = smem_bytes<T>(ROWS, r, rope);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mla_kernel<T, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, (h * S + ROWS - 1) / ROWS);
  paged_mla_kernel<T, ROWS><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<const int*>(table), static_cast<const int*>(qpos),
      static_cast<T*>(out), S, h, r, rope, W, ps, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* table, const void* qpos, void* out,
           int B, int S, int h, int r, int rope, int W, int ps, int window,
           float scale, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (B <= 0 || S <= 0 || h <= 0 || W <= 0 || ps <= 0 || r <= 0 || r > kMaxR ||
      r % kVec || rope <= 0 || rope > kMaxRope || rope % kVec)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // 16 rows a block, or 8 where 16 would leave SMs idle (decode: B * h / 16
  // blocks, 64 at 8 slots of 128 heads)
  const int tiles16 = B * ((h * S + kMaxRows - 1) / kMaxRows);
  return tiles16 < sms
      ? run<T, kMaxRows / 2>(q_lat, q_rope, ckv, krope, table, qpos, out, B, S,
                             h, r, rope, W, ps, window, scale, stream)
      : run<T, kMaxRows>(q_lat, q_rope, ckv, krope, table, qpos, out, B, S, h,
                         r, rope, W, ps, window, scale, stream);
}

}  // namespace

extern "C" {

int paged_flash_decode_mla_f32(const void* q_lat, const void* q_rope,
                               const void* ckv, const void* krope,
                               const void* table, const void* qpos, void* out,
                               int B, int S, int h, int r, int rope, int W, int ps,
                               int window, float scale, void* stream) {
  return launch<float>(q_lat, q_rope, ckv, krope, table, qpos, out, B, S, h, r,
                       rope, W, ps, window, scale, stream);
}

int paged_flash_decode_mla_bf16(const void* q_lat, const void* q_rope,
                                const void* ckv, const void* krope,
                                const void* table, const void* qpos, void* out,
                                int B, int S, int h, int r, int rope, int W, int ps,
                                int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q_lat, q_rope, ckv, krope, table, qpos, out, B, S,
                               h, r, rope, W, ps, window, scale, stream);
}

unsigned long long paged_flash_decode_mla_smem_bytes(int r, int rope, int elem_bytes) {
  return (unsigned long long)(elem_bytes == 4
                                  ? smem_bytes<float>(kMaxRows, r, rope)
                                  : smem_bytes<__nv_bfloat16>(kMaxRows, r, rope));
}

const char* paged_flash_decode_mla_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
