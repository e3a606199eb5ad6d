// The grid of a streaming kernel: how many CTAs of a kernel the current
// device holds at once, read from the runtime once per device and kernel.
//
// The element-wise kernels (eltwise.cu) size their grids to at most one
// full wave of resident CTAs, each thread walking its elements at a stride
// of the grid; the key switch's K11 (key_switch.cu) to 8 CTAs an SM. The
// SM count and a kernel's occupancy do not change while a process runs,
// so a launch reads them from static tables instead of asking the runtime
// again; only cudaGetDevice (a thread-local read) runs on every launch.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

constexpr int GRID_MAX_DEVICES = 64;

// One kernel's CTAs an SM per device; 0 where not read yet. A launch site
// keeps one as a static of the function that launches the kernel.
struct ResidentTable {
  std::atomic<int> per_sm[GRID_MAX_DEVICES];
};

// The SMs of `device`; 0 where the runtime refused the query.
static int sm_count(int device) {
  static std::atomic<int> table[GRID_MAX_DEVICES];
  const bool cached = device >= 0 && device < GRID_MAX_DEVICES;
  int sms = cached ? table[device].load(std::memory_order_relaxed) : 0;
  if (sms) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  if (cached) table[device].store(sms, std::memory_order_relaxed);
  return sms;
}

// The CTAs of `kernel` at `threads` threads and no dynamic shared memory
// that the current device holds at once (SMs x CTAs an SM, at least one),
// in *ctas; returns the runtime's error, or 0.
template <typename K>
static int resident_ctas(ResidentTable& table, K kernel, int threads,
                         long long* ctas) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const bool cached = device >= 0 && device < GRID_MAX_DEVICES;
  int per_sm = cached ? table.per_sm[device].load(std::memory_order_relaxed)
                      : 0;
  if (!per_sm) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
    if (cached) table.per_sm[device].store(per_sm, std::memory_order_relaxed);
  }
  const int sms = sm_count(device);
  if (!sms) return (int)cudaErrorInvalidDevice;
  *ctas = (long long)sms * per_sm;
  return 0;
}
