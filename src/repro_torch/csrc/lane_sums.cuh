// Transposed cross-lane sums of the Mamba scan kernels (csrc/mamba_scan.cu,
// csrc/mamba_scan_bwd.cu).  A lane holds its shares p[0 .. N) of N values;
// each level of the fold halves what a lane keeps and adds its partner's
// shares of those, so summing N values over 2^L lanes costs N (1 - 2^-L)
// shuffles a lane, not N L.

#pragma once

namespace scan {

// One level: lanes whose `bit` is set keep the upper HALF of their values,
// the others the lower, and each adds its partner's shares of the values it
// keeps.  Returns the index of the first kept value.
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

// The other direction: p[i] summed over the warp's 32 / LPC channels (lane
// bits LPC .. 16), each lane keeping its own channel-lane `lane % LPC`'s
// values: afterwards p[0 .. N LPC / 32) hold the sums of values s0 ..,
// s0 returned.  HALF starts at N / 2.
template <int HALF, int BIT, int N>
__device__ __forceinline__ int channel_sums(float (&p)[N], int lane) {
  int s0 = fold<HALF, BIT>(p, lane);
  if constexpr (BIT < 16) s0 += channel_sums<HALF / 2, BIT * 2>(p, lane);
  return s0;
}

}  // namespace scan
