// Absorbed-MLA paged flash-decode on Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel repro/kernels/paged_decode.py::paged_flash_decode_mla
// (body _mla_kernel).  DeepSeek-V3's multi-head latent attention caches one
// compressed latent per token instead of per-head K/V, and the decode attends
// in that latent space: every query head reads the same latent rows.  The
// kernels fuse the page-table gather into an fp32 online softmax, so the
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
// when window > 0).  The value is the latent ckv itself.  Masked keys
// contribute exactly 0, so pages the mask kills -- the trash page, unallocated
// blocks, the unwritten tail of the last page -- never reach the output, and a
// row with no visible key outputs 0.
//
// Bound: operations at a prefill chunk, bytes at a decode step.  A call reads
// each visible latent row once (r + rope values a token) but does 2 (2 r +
// rope) flops per (query row, visible key): at 128 heads every latent row
// serves 128 query rows, a dense product of M = 128 S rows, K = r + rope and
// N = r -- the tensor cores' work, not the CUDA cores'.
//
// bf16 (the path serving runs), the wgmma_bf16 kernel below; its plan is
// kernels/mla_split.py.  The design follows the shape of DeepSeek's FlashMLA:
//  * A block is two warpgroups (256 threads) owning 64 query rows of one slot,
//    taken position-major (row = s * h + head): at 128 heads all 64 rows sit at
//    one position, so they share one key range and only the last key tile
//    needs a mask.  Rows past the call's h * S are zero and never written.
//  * Shared memory holds the block's q tile [q_lat | q_rope] (64 x 576 bf16)
//    and a ring of two key tiles of 64 latent + rope rows, all in the wgmma
//    128-byte-swizzled K-major layout (sm90.cuh swz): columns of 64-value
//    atoms, the rope in an atom column of its own after 2 NV latent columns, so
//    the value product's descriptor covers exactly latent columns.  A key tile
//    is copied with cp.async, 16 bytes a thread, its page looked up once a key.
//    The q tile and the first key tile are copied by all threads; each later
//    tile by warpgroup 1 alone, into the other stage, while warpgroup 0
//    computes the scores of this one (a cp.async issue stalls while earlier
//    copies drain, so the score product never issues copies).
//  * Scores: warpgroup 0 runs S = [q_lat | q_rope] [ckv | krope]^T as wgmma
//    m64n64k16 from shared memory (36 k-steps at r 512, rope 64; a width that
//    is no multiple of 16 is zero-padded in shared memory), then the fp32
//    online softmax in exp2 with the scale folded in; masked scores are -inf
//    and the running max is floored at kNegInf.  It rounds P to bf16 and
//    writes it (8 KB) and each row's rescale factor to shared memory.
//  * Value product: each warpgroup rescales its accumulator and runs P V with
//    wgmma m64 x NV x 16 -- P from registers (warpgroup 0) or ldmatrix
//    (warpgroup 1), V the latent columns of the same staged tile through the
//    MN-major descriptor, so nothing is copied twice.  Warpgroup w owns output
//    columns [w NV, (w + 1) NV): at r 512, 256 each, 128 fp32 registers a
//    thread.
//  * Output: without a split, the normalised tile goes through shared memory
//    and out in whole 16-byte chunks of each row.
//  * Split-KV: the block's visible key tiles are cut into gridDim.x parts, one
//    a block of a thread-block cluster (kernels/mla_split.py chooses how many:
//    about one block an SM).  Each writes its partial (m, l, unnormalised
//    64 x r acc) into its freed key ring; after cluster.sync() rank k
//    combines rows [k nr / n, (k + 1) nr / n) from all ranks' partials through
//    distributed shared memory: first each row's split weights, then 8
//    columns a thread, in split order 0, 1, ..., so the output depends on the
//    data alone.  A split that sees no key has l = 0 and m = kNegInf and
//    contributes exactly 0.
//
// fp32: the first version's kernel (fma_f32 below), unchanged, and never TF32:
// the card-vs-CPU greedy parity of the fp32 serving runs (2e-5 bar) rests on
// it.  Rows are laid out head-major (row i = head * S + s) and cut into tiles
// of 16 (or 8 where 16 would leave SMs idle), one block per (slot, row tile);
// the block stages its q rows as fp32 and walks only the keys in [min_pos -
// window + 1, max_pos] of its rows in double-buffered cp.async tiles of 32
// latent + rope rows, both products as fp32 FMAs on the CUDA cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

namespace fma_f32 {

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

// four consecutive values of a staged row, as fp32 (8 or 16 bytes aligned)
__device__ __forceinline__ void load4(const float* src, float* dst) {
  load_vec(src, dst);
}

__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

__device__ __forceinline__ float to_f32(float x) { return x; }

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

}  // namespace fma_f32

namespace wgmma_bf16 {

using namespace sm90;
namespace cg = cooperative_groups;

constexpr int kRows = 64;        // query rows a block: one wgmma m-tile
constexpr int kKeys = 64;        // keys a staged tile
constexpr int kThreads = 256;    // two warpgroups
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr int kMaxRope = 64;     // the rope keys' one atom column
constexpr float kNegInf = -1e30f;   // running-max floor: exp2(m - m_new) stays finite
constexpr float kLog2e = 1.4426950408889634f;

// Tiles of 64 rows (q rows or keys): NV / 32 latent atom columns (the 2 NV
// output columns of the two warpgroups), then one rope atom column; each atom
// column is 64 rows of 128 bytes.
template <int NV>
struct Tile {
  static_assert(NV == 64 || NV == 128 || NV == 256, "wgmma N of 64, 128 or 256");
  static constexpr int kLatAtoms = NV / 32;
  static constexpr int kBytes = (kLatAtoms + 1) * kKeys * 128;
  static constexpr int kLda = 2 * NV + 4;   // fp32 row stride of a split's partial acc
  static_assert(kRows * kLda * 4 <= 2 * kBytes, "a split's partial fits the key ring");
};

// the q tile, two key tiles, P (64 x 64 bf16), per-row alpha, m, l; from a
// 1024-aligned start (hence the 1024 spare bytes)
template <int NV>
constexpr size_t smem_bytes() {
  return 1024 + 3 * (size_t)Tile<NV>::kBytes + kRows * kKeys * 2 + 3 * kRows * sizeof(float);
}

// Copy one 64-row tile row: the latent's 16-byte chunks u, u + 8, ... (chunks
// at or past r zero-filled) and rope chunk u (zero-filled past rope), or only
// zeros when !ok.
template <int NV>
__device__ __forceinline__ void copy_row(uint32_t tile, int row, int u, const bf16* lat,
                                         const bf16* rp, bool ok, int r, int rope,
                                         const bf16* any) {
  constexpr int LA = Tile<NV>::kLatAtoms;
#pragma unroll
  for (int a = 0; a < LA; ++a) {
    const int c = a * 8 + u;
    const bool live = ok && c * 8 < r;
    cp_async16(tile + swz<64, kKeys>(row, c), live ? lat + c * 8 : any, live);
  }
  const bool live = ok && u * 8 < rope;
  cp_async16(tile + swz<64, kKeys>(row, LA * 8 + u), live ? rp + u * 8 : any, live);
}

template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
mla_kernel(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_rope,
           const bf16* __restrict__ ckv, const bf16* __restrict__ krope,
           const int* __restrict__ table, const int* __restrict__ qpos,
           bf16* __restrict__ out, int S, int h, int r, int rope, int W, int ps,
           int window, float scale_log2) {
  constexpr int LA = Tile<NV>::kLatAtoms;
  constexpr int TILE = Tile<NV>::kBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kv_s = q_s + TILE;                  // [2][TILE]
  unsigned char* p_s = kv_s + 2 * TILE;              // 64 x 64 bf16, one atom column
  float* a_s = reinterpret_cast<float*>(p_s + kRows * kKeys * 2);
  float* m_s = a_s + kRows;
  float* l_s = m_s + kRows;

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int b = blockIdx.y;
  // row tiles last first: under the causal mask they see the most keys
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int nr = min(kRows, h * S - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int wrow = (warp & 3) * 16;                  // the warp's rows of the m-tile
  const size_t row0 = (size_t)b * S * h + r0;        // flat (slot, position, head) row of tile row 0

  // the positions of the block's rows: tile row i is query position (r0 + i) / h
  int p_lo = INT_MAX, p_hi = INT_MIN;
  for (int s = r0 / h + lane; s <= (r0 + nr - 1) / h; s += 32) {
    const int p = qpos[b * S + s];
    p_lo = min(p_lo, p);
    p_hi = max(p_hi, p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p_lo = min(p_lo, __shfl_xor_sync(0xffffffffu, p_lo, o));
    p_hi = max(p_hi, __shfl_xor_sync(0xffffffffu, p_hi, o));
  }
  // keys some row can see: [lo, hi]; this split's share of their tiles
  const int limit = W * ps;
  const int hi = p_hi < 0 ? -1 : min(p_hi, limit - 1);
  const int lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  int t_first = 0, t_end = 0;
  if (hi >= lo) {
    const int tl = lo / kKeys, n = hi / kKeys - tl + 1;
    t_first = tl + split * n / n_splits;
    t_end = tl + (split + 1) * n / n_splits;
  }

  // copies: a thread moves chunk u (of each atom) of every (threads / 8)-th
  // row from `row`; the q tile and the first key tile, by all threads, are
  // commit group 0.  Later key tiles are copied by warpgroup 1 alone, while
  // warpgroup 0 computes scores: a thread's cp.async issue stalls until
  // earlier copies drain, and the score product must not wait on it.
  const int u = tid & 7;
#pragma unroll
  for (int i = tid >> 3; i < kRows; i += kThreads / 8) {
    const bool ok = i < nr;
    const size_t row = ok ? row0 + i : 0;
    copy_row<NV>(smem_addr(q_s), i, u, q_lat + row * r, q_rope + row * rope, ok, r, rope, q_lat);
  }
  auto stage = [&](int tile, int st, int row, int threads) {
    const uint32_t dst = smem_addr(kv_s + st * TILE);
    for (int i = row; i < kKeys; i += threads / 8) {
      const int kp = tile * kKeys + i;
      const bool ok = kp >= lo && kp <= hi;
      const size_t tok = ok ? (size_t)table[(size_t)b * W + kp / ps] * ps + kp % ps : 0;
      copy_row<NV>(dst, i, u, ckv + tok * r, krope + tok * rope, ok, r, rope, ckv);
    }
  };
  if (t_first < t_end) stage(t_first, 0, tid >> 3, kThreads);
  cp_async_commit();

  // warpgroup 0's rows lane / 4 and lane / 4 + 8 of its warp: their positions
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow + (lane >> 2) + 8 * i;
    qp[i] = row < nr ? qpos[b * S + (r0 + row) / h] : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NV / 8][4];
#pragma unroll
  for (int n = 0; n < NV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool pv = wg * NV < r;                       // this warpgroup owns latent columns
  const int kl = (r + 15) / 16, kr = (rope + 15) / 16;   // k-steps of the score product
  const uint32_t q_addr = smem_addr(q_s), p_addr = smem_addr(p_s);

  for (int tile = t_first; tile < t_end; ++tile) {
    const int st = (tile - t_first) & 1;
    cp_async_wait<0>();                              // this tile (and q) have landed
    fence_proxy_async();                             // ... visible to wgmma
    __syncthreads();                                 // ... for every thread; both
                                                     // warpgroups are done with the
                                                     // last tile, its stage and P
    const uint32_t ks = smem_addr(kv_s + st * TILE);
    const int t0 = tile * kKeys;
    uint32_t a[kKeys / 16][4];                       // P, the A operand of P V
    if (wg == 1) {                                   // the next tile into the other stage
      if (tile + 1 < t_end) stage(tile + 1, st ^ 1, (tid - kThreads / 2) >> 3, kThreads / 2);
      cp_async_commit();
    } else {
      float s[kKeys / 8][4];
      wgmma_fence();
      for (int kc = 0; kc < kl; ++kc)
        wgmma_ss_n64(s, desc_k_major<64, kRows>(q_addr, kc, 0),
                     desc_k_major<64, kKeys>(ks, kc, 0), kc);
      for (int kc = 4 * LA; kc < 4 * LA + kr; ++kc)
        wgmma_ss_n64(s, desc_k_major<64, kRows>(q_addr, kc, 0),
                     desc_k_major<64, kKeys>(ks, kc, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      // scale into the exp2 domain; mask only a tile some row sees in part
      const bool full = t0 + kKeys - 1 <= p_lo && t0 + kKeys <= limit &&
                        (window <= 0 || t0 > p_hi - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (!full) {
            const int kp = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
            const int q = qp[e >> 1];
            const bool vis = kp <= q && kp < limit && (window <= 0 || kp > q - window);
            x = vis ? x : -INFINITY;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = fast_exp2(s[n][e] - m[e >> 1]);  // masked: exp2(-inf) = 0
          sum[e >> 1] += s[n][e];
        }
      }
      // P in bf16: in registers for this warpgroup's product, in shared
      // memory for warpgroup 1's, with the rows' rescale factors
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = l[i] * alpha[i] + sum[i];
        const int row = wrow + (lane >> 2) + 8 * i;
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
          *reinterpret_cast<uint32_t*>(p_s + swz<64, kRows>(row, n) + (lane & 3) * 4) =
              pack_bf16(s[n][2 * i], s[n][2 * i + 1]);
        if ((lane & 3) == 0) a_s[row] = alpha[i];
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) {
        acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
      }
    }
    __syncthreads();                                 // P and alpha are written
    if (wg == 1 && pv) {
      const float al0 = a_s[wrow + (lane >> 2)], al1 = a_s[wrow + (lane >> 2) + 8];
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) {
        acc[n][0] *= al0; acc[n][1] *= al0;
        acc[n][2] *= al1; acc[n][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        ldmatrix_x4(a[kk], p_addr + swz<64, kRows>(wrow + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                   kk * 2 + (lane >> 4)));
    }
    if (pv) {
      // O += P V: V is this warpgroup's latent atoms of the staged key tile
      const uint32_t vs = ks + wg * (NV / 64) * kKeys * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_rs<NV>(acc, a[kk], desc_mn_major<64, kKeys>(vs, kk));
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  cp_async_wait<0>();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = quad_sum(l[i]);
      if ((lane & 3) == 0) {
        m_s[wrow + (lane >> 2) + 8 * i] = m[i];
        l_s[wrow + (lane >> 2) + 8 * i] = l[i];
      }
    }
  }
  __syncthreads();                                   // m, l written; the key ring is free

  const int col0 = wg * NV + (lane & 3) * 2;         // this thread's first column
  if (n_splits == 1) {
    // the output tile through shared memory (the key ring is free), then
    // whole 16-byte chunks of each valid row
    unsigned char* o_s = kv_s;
    if (pv) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wrow + (lane >> 2) + 8 * i;
        const float inv = l_s[row] > 0.f ? 1.f / l_s[row] : 0.f;
#pragma unroll
        for (int n = 0; n < NV / 8; ++n)
          *reinterpret_cast<uint32_t*>(o_s + swz<64, kRows>(row, wg * NV / 8 + n) + (lane & 3) * 4) =
              pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      }
    }
    __syncthreads();
    const int cpr = r / 8;                           // 16-byte chunks a row
    for (int x = tid; x < nr * cpr; x += kThreads) {
      const int row = x / cpr, c = x % cpr;
      *reinterpret_cast<uint4*>(out + (row0 + row) * r + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + swz<64, kRows>(row, c));
    }
    return;
  }

  // split-KV: this block's partial acc into its key ring; after cluster.sync()
  // rank `split` combines rows [split nr / n, (split + 1) nr / n) from every
  // rank's partial through distributed shared memory
  constexpr int LDA = Tile<NV>::kLda;
  float* acc_s = reinterpret_cast<float*>(kv_s);     // [kRows][LDA]
  if (pv) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + (lane >> 2) + 8 * i;
#pragma unroll
      for (int n = 0; n < NV / 8; ++n)
        *reinterpret_cast<float2*>(acc_s + row * LDA + col0 + n * 8) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int row_lo = split * nr / n_splits, n_rows = (split + 1) * nr / n_splits - row_lo;
  // each of these rows' split weights exp2(m_sp - max m) / l (0 for a row
  // no split saw a key of), in the free P buffer
  float* w_s = reinterpret_cast<float*>(p_s);        // [kRows][kMaxSplits]
  if (tid < n_rows) {
    const int row = row_lo + tid;
    float ms[kMaxSplits], ls[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < n_splits) {
        ms[sp] = *cluster.map_shared_rank(m_s + row, sp);
        ls[sp] = *cluster.map_shared_rank(l_s + row, sp);
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < n_splits) mm = fmaxf(mm, ms[sp]);
    float ll = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < n_splits) {
        ms[sp] = fast_exp2(ms[sp] - mm);
        ll = fmaf(ls[sp], ms[sp], ll);                // in split order
      }
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < n_splits) w_s[tid * kMaxSplits + sp] = ms[sp] * inv;
  }
  __syncthreads();
  // the rows' outputs, 8 columns a thread: every rank's loads issued before
  // any is used (distributed shared memory is far); the sums in split order
  const int cpr = r / 8;
  for (int x = tid; x < n_rows * cpr; x += kThreads) {
    const int i = x / cpr, c = (x % cpr) * 8, row = row_lo + i;
    float4 as[kMaxSplits][2];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < n_splits) {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc_s + row * LDA + c, sp));
        as[sp][0] = src[0];
        as[sp][1] = src[1];
      }
    }
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < n_splits) {
        const float w = w_s[i * kMaxSplits + sp];
        o[0] = fmaf(as[sp][0].x, w, o[0]); o[1] = fmaf(as[sp][0].y, w, o[1]);
        o[2] = fmaf(as[sp][0].z, w, o[2]); o[3] = fmaf(as[sp][0].w, w, o[3]);
        o[4] = fmaf(as[sp][1].x, w, o[4]); o[5] = fmaf(as[sp][1].y, w, o[5]);
        o[6] = fmaf(as[sp][1].z, w, o[6]); o[7] = fmaf(as[sp][1].w, w, o[7]);
      }
    }
    *reinterpret_cast<uint4*>(out + (row0 + row) * r + c) =
        make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                   pack_bf16(o[6], o[7]));
  }
  cluster.sync();                                    // peers are done reading this block
}

// Launch one call: grid (splits, B, row tiles), a cluster of `splits` blocks
// along x when splits > 1.  Returns a cudaError_t as int.
template <int NV>
int launch_nv(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
              const void* table, const void* qpos, void* out, int B, int S, int h, int r,
              int rope, int W, int ps, int window, int splits, float scale,
              cudaStream_t stream) {
  const int row_tiles = (h * S + kRows - 1) / kRows;
  if (row_tiles > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes<NV>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B, row_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, mla_kernel<NV>, static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_rope),
      static_cast<const bf16*>(ckv), static_cast<const bf16*>(krope),
      static_cast<const int*>(table), static_cast<const int*>(qpos), static_cast<bf16*>(out),
      S, h, r, rope, W, ps, window, scale * kLog2e);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the warpgroups' output columns NV: the least of 64, 128, 256 with 2 NV >= r
inline int nv_for(int r) { return r <= 128 ? 64 : r <= 256 ? 128 : 256; }

int launch(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
           const void* table, const void* qpos, void* out, int B, int S, int h, int r,
           int rope, int W, int ps, int window, int splits, float scale, void* stream) {
  if (B <= 0 || S <= 0 || h <= 0 || W <= 0 || ps <= 0 || r <= 0 || r > 512 || r % 8 ||
      rope <= 0 || rope > kMaxRope || rope % 8 || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MLA_ARGS q_lat, q_rope, ckv, krope, table, qpos, out, B, S, h, r, rope, W, ps, \
                 window, splits, scale, st
  switch (nv_for(r)) {
    case 64: return launch_nv<64>(MLA_ARGS);
    case 128: return launch_nv<128>(MLA_ARGS);
    default: return launch_nv<256>(MLA_ARGS);
  }
#undef MLA_ARGS
}

size_t smem(int r) {
  switch (nv_for(r)) {
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    default: return smem_bytes<256>();
  }
}

}  // namespace wgmma_bf16

}  // namespace

extern "C" {

int paged_flash_decode_mla_f32(const void* q_lat, const void* q_rope,
                               const void* ckv, const void* krope,
                               const void* table, const void* qpos, void* out,
                               int B, int S, int h, int r, int rope, int W, int ps,
                               int window, float scale, void* stream) {
  return fma_f32::launch<float>(q_lat, q_rope, ckv, krope, table, qpos, out, B, S, h,
                                r, rope, W, ps, window, scale, stream);
}

int paged_flash_decode_mla_bf16(const void* q_lat, const void* q_rope,
                                const void* ckv, const void* krope,
                                const void* table, const void* qpos, void* out,
                                int B, int S, int h, int r, int rope, int W, int ps,
                                int window, int splits, float scale, void* stream) {
  return wgmma_bf16::launch(q_lat, q_rope, ckv, krope, table, qpos, out, B, S, h, r,
                            rope, W, ps, window, splits, scale, stream);
}

unsigned long long paged_flash_decode_mla_smem_bytes(int r, int rope, int elem_bytes) {
  return (unsigned long long)(elem_bytes == 4
                                  ? fma_f32::smem_bytes<float>(fma_f32::kMaxRows, r, rope)
                                  : wgmma_bf16::smem(r));
}

const char* paged_flash_decode_mla_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
