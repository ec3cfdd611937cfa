// A device mark of utils/tracing.py: one thread writes the device's
// %globaltimer (ns) into ring[slot % slots][mark] of an int64 ring of
// [slots, marks], where slot is the ring's device slot counter, and the
// last mark of a pass or step (advance != 0) adds one to that counter.
//
// Launched on the stream of the work it marks, it runs once everything
// queued before it on that stream has finished, so the difference of two
// marks is the device time of the work between them, gaps included.  It
// reads the counter on the device, so a CUDA graph that captured it writes
// a new slot at every replay with nothing read or written by the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void trace_mark_kernel(int64_t* ring, int64_t* slot, int mark,
                                  int marks, int slots, int advance) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int64_t s = *slot;
  ring[(s % slots) * marks + mark] = (int64_t)now;
  if (advance) *slot = s + 1;
}

}  // namespace

extern "C" {

// Launches the mark on `stream`; returns the launch's cudaError_t (0 on
// success).  ring and slot are device memory.
int trace_mark(int64_t* ring, int64_t* slot, int mark, int marks, int slots,
               int advance, cudaStream_t stream) {
  trace_mark_kernel<<<1, 1, 0, stream>>>(ring, slot, mark, marks, slots,
                                         advance);
  return (int)cudaGetLastError();
}

}  // extern "C"
