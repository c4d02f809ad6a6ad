// Clock-stamp probe of the scan kernels' phases (csrc/wkv6.cu, csrc/wkv6_bwd.cu,
// csrc/mamba_scan.cu), compiled only with -DSCAN_PROBE: the default build
// defines nothing here but empty marks, so the shipped kernels carry no
// probe code.  launch/probe_scans.py builds the probe variant.
//
// Every thread reads clock64() at each mark; thread 0 of each block adds the
// cycles since the previous mark into the phase's slot and, at the end,
// writes its sums to a global table that <stem>_probe_read copies out.  A
// mark placed after a barrier times the whole block's phase.

#pragma once

#ifdef SCAN_PROBE

#include <cuda_runtime.h>

constexpr int kProbeSlots = 8;
constexpr int kProbeBlocks = 4096;
__device__ long long g_probe[kProbeBlocks][kProbeSlots];

#define PROBE_START()                      \
  long long probe_t_ = clock64();          \
  long long probe_acc_[kProbeSlots] = {}
#define PROBE_MARK(slot)                   \
  do {                                     \
    const long long now_ = clock64();      \
    probe_acc_[slot] += now_ - probe_t_;   \
    probe_t_ = now_;                       \
  } while (0)
#define PROBE_END(block)                                                   \
  do {                                                                     \
    if (threadIdx.x == 0 && (block) < kProbeBlocks)                        \
      for (int i_ = 0; i_ < kProbeSlots; ++i_) g_probe[block][i_] = probe_acc_[i_]; \
  } while (0)
// int <prefix>_probe_read(void* dst, int blocks): the first `blocks` rows of
// the table (kProbeSlots int64 each) into host memory, after the kernel ended
#define PROBE_EXPORT(prefix)                                                  \
  extern "C" int prefix##_probe_read(void* dst, int blocks) {                 \
    if (blocks < 0 || blocks > kProbeBlocks) return (int)cudaErrorInvalidValue; \
    return (int)cudaMemcpyFromSymbol(dst, g_probe,                            \
                                     (size_t)blocks * kProbeSlots * sizeof(long long)); \
  }

#else

#define PROBE_START() \
  do {                \
  } while (0)
#define PROBE_MARK(slot) \
  do {                   \
  } while (0)
#define PROBE_END(block) \
  do {                   \
  } while (0)
#define PROBE_EXPORT(prefix)

#endif
