// The stage stamps of a captured step (trace.py Stamps): one thread writes
// the device's %globaltimer (nanoseconds) at one stage boundary.
//
// Replaces no TPU kernel: it is the tracer's, launched only inside the
// stamped twin of a captured step (pipeline.CapturedStep), never on the
// main path, and counted in no launch counter. A replay's S + 1 stamps go
// into row (count mod rows) of a (rows, width) int64 ring; the replay's
// last stamp advances count, which lives in device memory, so replays in
// flight one behind the other write rows of their own and nothing is read
// back per replay. Each stamp runs after the kernels launched before it on
// the stream have finished, so stamp k + 1 minus stamp k is the device time
// of the stage between them (with one stamp's launch in it).
// Bound: latency, one launch of one thread, 8 bytes written.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* ring, long long* count, int rows, int width, int slot,
                             int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long row = *count;
  ring[(row % rows) * width + slot] = (long long)now;
  if (last) *count = row + 1;
}

}  // namespace

// ring: (rows, width) int64; count: one int64, the replays stamped so far;
// slot: the column written, 0 <= slot < width; last: nonzero on a replay's
// last stamp.
extern "C" int gg_stamp(long long* ring, long long* count, int rows, int width, int slot,
                        int last, cudaStream_t stream) {
  if (rows < 1 || width < 1 || slot < 0 || slot >= width) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, stream>>>(ring, count, rows, width, slot, last);
  return (int)cudaGetLastError();
}
