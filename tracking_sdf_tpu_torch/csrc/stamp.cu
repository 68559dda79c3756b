// The device's clock for the chunk step's traced variant
// (utils/profiling.py `device_stamp`). One thread reads %globaltimer, the
// nanosecond timer that every SM shares, and stores it as one int64. Two
// stamps, a frame step's first and last operation, bound the frame's device
// time; a stamp and the next frame's first bound the time the card waited
// between the replays. It is no compute kernel: the launch counters of the
// kernel wrappers leave it out.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
}

}  // namespace

extern "C" int tsdf_device_stamp(void* out, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
