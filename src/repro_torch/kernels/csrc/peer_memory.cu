// Device memory that the processes of a tensor-parallel group share, and
// the counters in it that streams wait on: what K3's and K4's exchanges
// across processes stand on (kernels/peer_memory.py).
//
// On the TPU a kernel writes into, or reads from, a peer chip's memory by
// remote DMA and orders itself by DMA semaphores.  Here each rank
// allocates its part with cudaMalloc (a block of PyTorch's caching
// allocator is a sub-allocation, whose IPC handle names its whole
// segment), exports it once by a CUDA IPC handle, and maps every peer's
// part from the handles gathered over the group's control group.  The
// mapping works alike between cards (NVLink) and between contexts on one
// card.  The semaphores become 32-bit counters in that memory, driven by
// stream memory operations (stream_flags.cuh).
//
// Every entry point returns 0, a cudaError_t, or a driver error negated;
// peer_memory_strerror reads both kinds.

#include <cuda_runtime.h>

#include <cstring>

#include "stream_flags.cuh"

// `bytes` of zeroed device memory at *ptr and its IPC handle (the
// allocation whole: cudaMalloc, not a caching allocator's sub-block).
extern "C" int peer_alloc(long long bytes, void** ptr, void* handle) {
  if (bytes < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess)
    err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    cudaIpcMemHandle_t h;
    err = cudaIpcGetMemHandle(&h, *ptr);
    if (err == cudaSuccess) std::memcpy(handle, &h, sizeof h);
  }
  return err;
}

// A peer's allocation mapped into this process, from its handle.
extern "C" int peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int peer_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

extern "C" int peer_free(void* ptr) { return cudaFree(ptr); }

extern "C" int peer_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// `stream` waits until each of the n flags reaches `value`.
extern "C" int peer_flags_wait(void* const* flags, int n, unsigned value,
                               void* stream) {
  for (int i = 0; i < n; ++i) {
    const int err = stream_flags::wait_flag(
        static_cast<cudaStream_t>(stream), flags[i], value);
    if (err) return err;
  }
  return 0;
}

// Each of the n flags is set to `value` after the stream's earlier work.
extern "C" int peer_flags_write(void* const* flags, int n, unsigned value,
                                void* stream) {
  for (int i = 0; i < n; ++i) {
    const int err = stream_flags::write_flag(
        static_cast<cudaStream_t>(stream), flags[i], value);
    if (err) return err;
  }
  return 0;
}

// CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES of the current device: 1
// where a wait may carry CU_STREAM_WAIT_VALUE_FLUSH, which makes remote
// writes that reached the device before the wait visible to the work
// after it.
extern "C" int peer_can_flush_remote_writes(int* can) {
  using GetAttribute = CUresult (*)(int*, CUdevice_attribute, CUdevice);
  static const GetAttribute fn =
      stream_flags::driver_fn<GetAttribute>("cuDeviceGetAttribute");
  if (!fn) return cudaErrorNotSupported;
  int dev;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const CUresult r =
      fn(can, CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES, dev);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

extern "C" const char* peer_memory_strerror(int err) {
  return stream_flags::flag_strerror(err);
}
