// Paged flash-decode for GQA on Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel repro/kernels/paged_decode.py::paged_flash_decode
// (body _gqa_kernel).  It fuses the page-table gather into an fp32 online
// softmax: the slot-major gather of the pool never exists in device memory.
//
// Contract (the same as the plain PyTorch version, paged_read followed by
// masked_attention):
//   q      (B, S, h, hd)   T         queries (decode: S = 1, prefill chunk: S <= 32)
//   pools  (N, hk, hd)     T         token-major page pools, N = pages * page_size
//   table  (B, W)          int32     physical page of each logical block, 0 = trash
//   pos    (B, S)          int32     logical position of each query
//   out    (B, S, h, hd)   T
// Key t is visible to query (b, s) iff t <= pos[b, s] (and t > pos[b, s] - window
// when window > 0).  Query head i reads KV head i / (h / hk).  Masked keys
// contribute exactly 0, so pages the mask kills -- the trash page, unallocated
// blocks, the unwritten tail of the last page -- never reach the output, and
// rows with no visible key output 0.
//
// bf16 (the path serving runs): the shared tensor-core core of
// gqa_attention.cuh with PagedPolicy below -- the block loads its table row
// and its rows' positions into shared memory once, walks only the keys in
// [min_pos - window + 1, max_pos], and looks each staged key row's page up
// once.  The wrapper's plan: decode steps and prefill chunks run one-warp
// blocks (16 rows, mma.sync, a ring of 32-key cp.async tiles) with the keys
// split over a thread-block cluster of up to 8 blocks, so 8 slots fill the
// 132 SMs.  Bound: memory, sum_b visible_tokens_b * hk * hd * 2 * 2 bytes
// plus q and out.
//
// fp32: the first version's kernel below, unchanged, and never TF32: the
// card-vs-CPU greedy parity of the fp32 serving runs (2e-5 bar) rests on it.
// One block per (slot, kv head, tile of up to `rows_per_block` query rows)
// walks the visible pages in tiles of `pages_per_tile` pages, stages K and V in
// shared memory as fp32, and carries the rows' (m, l, acc) in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "gqa_attention.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // running-max floor: exp(m_prev - m_new) stays finite
constexpr int kThreads = 256;

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

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

size_t smem_bytes(int rt, int kt, int hd) {
  const size_t floats = (size_t)rt * (hd + 1)   // q rows (padded stride)
                        + (size_t)kt * (hd + 1) // K tile (padded stride)
                        + (size_t)kt * hd       // V tile
                        + (size_t)rt * kt       // scores / probabilities
                        + (size_t)rt * hd       // accumulator
                        + 3 * (size_t)rt;       // m, l, alpha
  return floats * sizeof(float) + (size_t)rt * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ table,
                 const int* __restrict__ qpos, T* __restrict__ out,
                 int S, int h, int hk, int hd, int W, int ps, int window,
                 int rt, int pages_per_tile, float scale) {
  extern __shared__ float smem[];
  const int kt = pages_per_tile * ps;
  const int ldk = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + (size_t)rt * ldk;
  float* v_s = k_s + (size_t)kt * ldk;
  float* p_s = v_s + (size_t)kt * hd;
  float* acc = p_s + (size_t)rt * kt;
  float* m_s = acc + (size_t)rt * hd;
  float* l_s = m_s + rt;
  float* a_s = l_s + rt;
  int* qp_s = reinterpret_cast<int*>(a_s + rt);

  const int b = blockIdx.x / hk;
  const int kvh = blockIdx.x % hk;
  const int g = h / hk;
  const int r0 = blockIdx.y * rt;
  const int nr = min(rt, g * S - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = hd / kVec;

  // Row r of the tile is query row r0 + r of the (g, S) group layout:
  // group member gi = row / S (query head kvh * g + gi), query s = row % S.
  for (int r = tid; r < rt; r += blockDim.x) {
    qp_s[r] = r < nr ? qpos[b * S + (r0 + r) % S] : -1;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < rt * hd; i += blockDim.x) acc[i] = 0.f;
  for (int c = tid; c < nr * vpr; c += blockDim.x) {
    const int r = c / vpr, d0 = (c % vpr) * kVec;
    const int row = r0 + r, head = kvh * g + row / S, s = row % S;
    load_vec(q + (((size_t)b * S + s) * h + head) * hd + d0, q_s + r * ldk + d0);
  }
  __syncthreads();

  int maxpos = -1, minpos = INT_MAX;
  for (int r = 0; r < nr; ++r) {
    maxpos = max(maxpos, qp_s[r]);
    minpos = min(minpos, qp_s[r]);
  }
  // Pages that can hold a visible key: [w_lo, w_hi].  Past w_hi every key is
  // beyond every query (unwritten or trash); before w_lo the window kills it.
  const int w_hi = maxpos < 0 ? -1 : min(W - 1, maxpos / ps);
  int w_lo = 0;
  if (window > 0 && minpos - window + 1 > 0) w_lo = (minpos - window + 1) / ps;

  for (int w0 = w_lo; w0 <= w_hi; w0 += pages_per_tile) {
    __syncthreads();  // the previous tile's readers are done with k_s / v_s / p_s
    for (int c = tid; c < kt * vpr; c += blockDim.x) {
      const int t = c / vpr, d0 = (c % vpr) * kVec;
      const int w = w0 + t / ps;
      float* kd = k_s + t * ldk + d0;
      float* vd = v_s + t * hd + d0;
      if (w <= w_hi) {
        const size_t tok = (size_t)table[b * W + w] * ps + t % ps;
        const size_t off = (tok * hk + kvh) * hd + d0;
        load_vec(k_pool + off, kd);
        load_vec(v_pool + off, vd);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) { kd[i] = 0.f; vd[i] = 0.f; }
      }
    }
    __syncthreads();

    // scores: one (row, key) pair per thread step, fp32 dot over hd
    for (int idx = tid; idx < nr * kt; idx += blockDim.x) {
      const int r = idx / kt, t = idx % kt;
      const int kpos = w0 * ps + t;
      const int qp = qp_s[r];
      const bool vis = (w0 + t / ps <= w_hi) && kpos <= qp &&
                       (window <= 0 || kpos > qp - window);
      float sc = -INFINITY;
      if (vis) {
        const float* qr = q_s + r * ldk;
        const float* kr = k_s + t * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      p_s[idx] = sc;
    }
    __syncthreads();

    // online-softmax update, one warp per row
    for (int r = warp; r < nr; r += nwarps) {
      float* pr = p_s + r * kt;
      float mx = -INFINITY;
      for (int t = lane; t < kt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kt; t += 32) {
        const float e = expf(pr[t] - m_new);  // masked: exp(-inf) = 0
        pr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < nr * hd; idx += blockDim.x) {
      const int r = idx / hd, d = idx % hd;
      const float* pr = p_s + r * kt;
      float a = acc[idx] * a_s[r];
      for (int t = 0; t < kt; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < nr * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    const int row = r0 + r, head = kvh * g + row / S, s = row % S;
    const float l = l_s[r];
    store_out(out + (((size_t)b * S + s) * h + head) * hd + d,
              l > 0.f ? acc[idx] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* qpos, void* out, int B, int S, int h,
           int hk, int hd, int W, int ps, int window, int rows_per_block,
           int pages_per_tile, float scale, void* stream) {
  if (B <= 0 || S <= 0 || hk <= 0 || h % hk || hd % 8 || rows_per_block <= 0 ||
      pages_per_tile <= 0 || ps <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = (h / hk) * S;
  const int rt = rows_per_block < rows ? rows_per_block : rows;
  const size_t smem = smem_bytes(rt, pages_per_tile * ps, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_gqa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * hk, (rows + rt - 1) / rt);
  paged_gqa_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(qpos), static_cast<T*>(out), S, h, hk, hd, W, ps,
      window, rt, pages_per_tile, scale);
  return (int)cudaGetLastError();
}

// bf16: where the core finds key row t (through the slot's page table) and
// the query rows' positions (an int32 array: row r of the tile is query
// (r0 + r) / g)
template <int HD>
struct PagedPolicy {
  static constexpr int kHD = HD;
  static constexpr bool kPrepare = true;
  static constexpr int causal = 1;
  const gqa::bf16* k;
  const gqa::bf16* v;
  const int* table;
  const int* pos;
  int W, ps, hk, window;
  int kvh, min_pos, max_pos;             // set by begin()
  long long* row_s;                      // [kMaxRowSlots] element offsets of key rows
  int* tab_s;                            // [W] the slot's table row
  int* qp_s;                             // [rows] the tile rows' positions

  static size_t extra_bytes(int W, int rows) {
    return gqa::kMaxRowSlots * sizeof(long long) + ((size_t)W + rows) * sizeof(int);
  }
  __device__ void begin(int b, int kvh_, int r0, int nr, int g, int S, unsigned char* extra) {
    kvh = kvh_;
    row_s = reinterpret_cast<long long*>(extra);
    tab_s = reinterpret_cast<int*>(row_s + gqa::kMaxRowSlots);
    qp_s = tab_s + W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) tab_s[i] = table[(size_t)b * W + i];
    for (int r = threadIdx.x; r < nr; r += blockDim.x) qp_s[r] = pos[(size_t)b * S + (r0 + r) / g];
    __syncthreads();
    min_pos = INT_MAX;
    max_pos = -1;
    for (int r = 0; r < nr; ++r) {
      min_pos = min(min_pos, qp_s[r]);
      max_pos = max(max_pos, qp_s[r]);
    }
  }
  __device__ int qpos(int r) const { return qp_s[r]; }
  __device__ void key_range(int& lo, int& hi) const {
    hi = max_pos < 0 ? -1 : min(max_pos, W * ps - 1);
    lo = window > 0 ? max(0, min_pos - window + 1) : 0;
  }
  __device__ int key_limit() const { return W * ps; }
  __device__ void prepare(int t0, int slot, int n) {   // each key's page looked up once
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int kpos = t0 + t;
      if (kpos < W * ps)
        row_s[slot + t] = ((long long)tab_s[kpos / ps] * ps + kpos % ps) * hk * HD + kvh * HD;
    }
  }
  __device__ const gqa::bf16* k_row(int slot, int) const { return k + row_s[slot]; }
  __device__ const gqa::bf16* v_row(int slot, int) const { return v + row_s[slot]; }
};

template <int HD>
int launch_bf16_hd(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* qpos, void* out, int B, int S, int h,
                   int hk, int W, int ps, int window, int warps, int splits, float scale,
                   cudaStream_t stream) {
  PagedPolicy<HD> pol{};
  pol.k = static_cast<const gqa::bf16*>(k_pool);
  pol.v = static_cast<const gqa::bf16*>(v_pool);
  pol.table = static_cast<const int*>(table);
  pol.pos = static_cast<const int*>(qpos);
  pol.W = W; pol.ps = ps; pol.hk = hk; pol.window = window;
  const size_t extra = PagedPolicy<HD>::extra_bytes(W, warps == 4 ? gqa::rows_per_block<4>() : gqa::rows_per_block<1>());
  if (warps == 4)
    return gqa::launch<4>(pol, q, out, B, S, h, hk, splits, scale, extra, stream);
  if (warps == 1)
    return gqa::launch<1>(pol, q, out, B, S, h, hk, splits, scale, extra, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int paged_flash_decode_f32(const void* q, const void* k_pool, const void* v_pool,
                           const void* table, const void* qpos, void* out, int B,
                           int S, int h, int hk, int hd, int W, int ps, int window,
                           int rows_per_block, int pages_per_tile, float scale,
                           void* stream) {
  return launch<float>(q, k_pool, v_pool, table, qpos, out, B, S, h, hk, hd, W, ps,
                       window, rows_per_block, pages_per_tile, scale, stream);
}

int paged_flash_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                            const void* table, const void* qpos, void* out, int B,
                            int S, int h, int hk, int hd, int W, int ps, int window,
                            int warps, int splits, float scale, void* stream) {
  if (B <= 0 || S <= 0 || hk <= 0 || h % hk || ps <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS q, k_pool, v_pool, table, qpos, out, B, S, h, hk, W, ps, window, \
                   warps, splits, scale, st
  if (hd == 32) return launch_bf16_hd<32>(PAGED_ARGS);
  if (hd == 64) return launch_bf16_hd<64>(PAGED_ARGS);
  if (hd == 128) return launch_bf16_hd<128>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

unsigned long long paged_flash_decode_smem_bytes(int rows_per_block, int keys_per_tile,
                                                 int hd) {
  return (unsigned long long)smem_bytes(rows_per_block, keys_per_tile, hd);
}

unsigned long long paged_flash_decode_bf16_smem_bytes(int hd, int warps, int W) {
  const size_t core = warps == 4 ? gqa::core_smem_bytes<4>(hd) : gqa::core_smem_bytes<1>(hd);
  return (unsigned long long)(core + PagedPolicy<128>::extra_bytes(W, warps == 4 ? gqa::rows_per_block<4>() : gqa::rows_per_block<1>()));
}

const char* paged_flash_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
