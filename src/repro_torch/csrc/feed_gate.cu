// The device-side gate of the Fig.-8 pipelined restore, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The reference pulls each layer's disk rows
// into its jitted layer scan through an ordered io_callback
// (src/repro/models/dense.py:567): the compiled program stops at the
// callback until the host hands it the layer's rows.  A captured CUDA
// graph cannot call the host, so the port turns the callback around:
// the restore's feed thread (core/restore.py LayerFeed) writes layer l's
// rows into page-locked host buffers and then publishes the restore's
// generation in the host word flags[l] (feed_publish: a release store);
// the graph's gate for layer l waits for that word on the device, and
// the layer's copies of those rows to the device follow it on the
// stream.  So one restore is one replay, and the host waits only once,
// after it.
//
// feed_gate_kernel: one block of one thread.  It returns at once where
// an earlier layer's gate already failed (status != 0).  Otherwise it
// reads flags[layer] with a system-scope acquire load (the word lies in
// page-locked host memory, mapped into the device's address space) with
// __nanosleep between reads (32 ns doubling to 1 us: the word is read
// over PCIe, and a tighter loop only adds traffic), until
//   * the word equals gen: the layer's rows are in the host buffers and
//     visible (the feed's release store orders them before the word);
//   * the word equals -gen: the feed failed; status = 1;
//   * deadline_ns[0] nanoseconds have passed by %globaltimer since this
//     gate began to wait: status = 2 (a feed that never publishes leaves
//     no kernel spinning; later gates pass through).
// It adds the time it waited to wait_ns[layer].  gen and the deadline are
// read from device memory: a captured graph takes each call's values
// from its static inputs.  A word of an earlier restore (another
// generation) is neither success nor failure, so no flag is ever reset
// while a gate may read it.
//
// Bound: none of the card's.  The kernel moves 4 bytes a poll and
// computes nothing; its time is the feed's (the disk reads and the
// numpy dequantize of the layer), which is what it measures.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int load_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void feed_gate_kernel(const int* flags, int layer, const int* gen,
                                 const long long* deadline_ns, int* status,
                                 long long* wait_ns) {
  if (*status != 0) return;
  const int want = *gen;
  const long long budget = *deadline_ns;
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  int code = 0;
  for (;;) {
    const int word = load_acquire_sys(flags + layer);
    if (word == want) break;
    if (word == -want) {
      code = 1;
      break;
    }
    if ((long long)(global_ns() - t0) > budget) {
      code = 2;
      break;
    }
    __nanosleep(sleep_ns);
    if (sleep_ns < 1024) sleep_ns *= 2;
  }
  wait_ns[layer] += (long long)(global_ns() - t0);
  if (code != 0) *status = code;
}

}  // namespace

// flags: the device's pointer to the page-locked words
// (feed_flags_device_pointer); gen int32, deadline_ns int64, status
// int32 (1,) and wait_ns int64 (L,) in device memory.  -> the launch's
// cudaGetLastError.
extern "C" int feed_gate(const void* flags, int layer, const void* gen,
                         const void* deadline_ns, void* status, void* wait_ns,
                         void* stream) {
  if (flags == nullptr || layer < 0) return -1;
  feed_gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flags), layer, static_cast<const int*>(gen),
      static_cast<const long long*>(deadline_ns), static_cast<int*>(status),
      static_cast<long long*>(wait_ns));
  return (int)cudaGetLastError();
}

// The feed's side, on the host: layer's word set to ``word`` (the
// generation, or its negative on a failure) by a release store, so that
// every row the calling thread wrote before is visible first.
extern "C" void feed_publish(int* flags, int layer, int word) {
  __atomic_store_n(flags + layer, word, __ATOMIC_RELEASE);
}

// The device's pointer to page-locked host memory at ``host`` (the same
// address under unified addressing).  -> cudaHostGetDevicePointer's
// error code.
extern "C" int feed_flags_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}
