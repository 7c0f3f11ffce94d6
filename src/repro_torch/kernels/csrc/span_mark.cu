// The span mark: one thread that reads the device's global nanosecond
// timer and charges the time since the previous mark to one accumulator
// slot (repro_torch/spans.py).  It replaces no TPU kernel: the JAX
// package has no device spans.  It exists so that spans survive CUDA-graph
// replay: a mark is a kernel node of the captured step, so every replay
// charges its sections again, and nothing is read on the host per step.
//
// State, all on the device:
//   acc[n_slots]  int64 nanoseconds per span name (self time);
//   last[0]       the previous mark's %globaltimer, 0 before the first.
// A mark with slot >= 0 adds (now - last) to acc[slot] (once a previous
// mark exists); slot < 0 (no span open) only sets the time.  Marks run in
// stream order, one thread each, so no two touch the state at once.
//
// Bound: launch latency; it moves 16 bytes.  Design: the least a kernel
// can be, so that a mark costs what a graph node costs and no more.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void span_mark_kernel(long long* acc, unsigned long long* last,
                                 int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long prev = *last;
  if (slot >= 0 && prev != 0ull) acc[slot] += (long long)(now - prev);
  *last = now;
}

extern "C" int span_mark_launch(void* acc, void* last, int slot,
                                void* stream) {
  span_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)acc, (unsigned long long*)last, slot);
  return (int)cudaGetLastError();
}
