// The persistent refill loop's shared parts, for the fused loop
// (fused.cuh fused_kernel_refill) and the golden loop (golden.cuh
// golden_kernel_refill): a warp's reserve of rays and what a vote takes
// from the ray counter (refill_more, refill_next: __host__ __device__, the
// host tests' emulations call them too), and the persistent grid of a
// refill kernel on the current device (the occupancy of its instantiation
// and the SM count, each read once a device).  What the loop does is
// described at the top of fused.cuh.
#pragma once

#include "media.cuh"

namespace rt {

// A warp's reserve in the refill loop: the rays [held, held + left) that
// it took from the counter and has not begun, the same on every lane
struct Reserve {
  long long held;
  int left;
};

// What the leader of a vote in which k lanes need a ray takes from the
// counter: 0 while the reserve holds k rays, else what it lacks, at least
// chunk
RT_HD int refill_more(const Reserve& w, int k, int chunk) {
  if (w.left >= k) return 0;
  return k - w.left > chunk ? k - w.left : chunk;
}

// The ray index of the voter of rank `rank` among the k lanes that need a
// ray, and the reserve after the vote, as every lane of the warp computes
// them: the voters take the reserve first, in rank order, then the rays
// [taken + base, taken + base + more) that the leader's atomicAdd of `more`
// (refill_more) returned at `base`; rays [0, taken) are the threads' first.
// Where more is 0 every voter's rank is below w.left.
RT_HD long long refill_next(Reserve& w, int k, int rank, int more,
                            long long taken, int base) {
  // a voter of rank r past the reserve takes ray fresh + r
  const long long fresh = taken + base - w.left;
  const long long next = rank < w.left ? w.held + rank : fresh + rank;
  w.held = more == 0 ? w.held + k : fresh + k;
  w.left += more - k;
  return next;
}

#ifdef __CUDACC__

// The least rays a warp of the refill loop takes from the counter at once;
// it keeps the rest for its next refills.  One atomicAdd a ray would queue
// the warps of a short launch on the counter's one address; a larger chunk
// leaves more rays held by one warp when the counter runs out, which
// lengthens the launch's tail.
constexpr int kRefillChunk = 8;

// the devices whose SM counts and occupancies are cached
constexpr int kMaxDevices = 64;

// the current device, in [0, kMaxDevices)
static int current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < 0 || *dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  return 0;
}

// the SMs of device dev, read once a device
static int sm_count(int dev, int* sms) {
  static int cached[kMaxDevices];
  if (cached[dev] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = cached[dev];
  return 0;
}

// the grid of the refill kernel `kernel` for n rays on the current device:
// as many blocks as every SM holds at once (its occupancy, read once a
// device into per_sm, the caller's cache of kMaxDevices ints), never more
// than the rays fill
template <class Kernel>
static int persistent_grid(Kernel kernel, int* per_sm, int n, int* blocks) {
  int dev = 0, sms = 0;
  int err = current_device(&dev);
  if (err != 0) return err;
  if (per_sm[dev] == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev], kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm[dev] <= 0)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = sm_count(dev, &sms);
  if (err != 0) return err;
  const long long fill = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm[dev]) * sms;
  *blocks = static_cast<int>(fill < most ? fill : most);
  return 0;
}

#endif  // __CUDACC__

}  // namespace rt
