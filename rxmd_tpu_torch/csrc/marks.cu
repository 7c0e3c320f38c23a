// The device's marks for the port's trace (utils/timers.py), bound with
// ctypes.
//
// Replaces no TPU kernel: rxmd_tpu traces with the profiler of its XLA
// programs.  The port runs its steps, blocks, probes and rebuilds as CUDA
// graphs, whose replays no host clock and no CUDA event can split (an event
// captured into a graph is overwritten by the next replay).  So the device
// stamps its own time: a mark is one thread that takes the next slot of a
// ring in device memory by atomicAdd and writes the mark's id and the
// device's %globaltimer (nanoseconds) there.  Captured into a graph, every
// replay appends its marks after the last one; the host reads the ring only
// while a profiler session records.
//
// Bound by launch latency alone (16 bytes written a mark): a graph node,
// about a microsecond of the device's time.
//
// Layout: ring[0] holds the count of marks ever taken (its slot 1 unused),
// ring[1 + (i & mask)] mark i as (id, ns); mask + 1 is a power of two.
#include <cuda_runtime.h>

__global__ void mark_kernel(unsigned long long* ring, unsigned long long mask,
                            long long id) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long i = atomicAdd(ring, 1ULL);
  unsigned long long* slot = ring + 2 * (1 + (i & mask));
  slot[0] = (unsigned long long)id;
  slot[1] = t;
}

extern "C" int rxmd_mark(void* ring, long long mask, long long id,
                         void* stream) {
  mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, (unsigned long long)mask, id);
  return (int)cudaGetLastError();
}

extern "C" const char* rxmd_mark_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
