// 32-bit counters in device memory that streams wait on and write, the
// port's form of the TPU kernels' DMA semaphores across processes
// (peer_memory.cu exports the memory; dma_exchange.cu's push and K4's
// wrapper drive the counters around their copies and launches).
//
//  * wait_flag: `stream` waits until the counter reaches `value`
//    (cuStreamWaitValue32, GEQ, a cyclic 32-bit comparison);
//  * write_flag: the counter is set to `value` after the stream's earlier
//    work (cuStreamWriteValue32 with its default fence: the write lands
//    after the stream's copies and kernels).
// Neither waits on the host and neither spins an SM.  The CUDA driver API
// is reached through cudaGetDriverEntryPoint, so nothing links libcuda.
// Both return 0, cudaErrorNotSupported where the driver lacks the call,
// or a driver error negated (-CUresult); flag_strerror reads both kinds.
#pragma once

#include <cuda.h>  // CUstream, CUdeviceptr and the stream-memop enums
#include <cuda_runtime.h>

namespace stream_flags {

// A driver function by name, or nullptr where the driver lacks it.
template <typename Fn>
inline Fn driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess
             ? reinterpret_cast<Fn>(p)
             : nullptr;
}

using StreamValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t,
                                   unsigned int);
using ErrorString = CUresult (*)(CUresult, const char**);

inline int stream_value(StreamValue32 fn, cudaStream_t stream, void* flag,
                        unsigned value, unsigned flags) {
  if (!fn) return cudaErrorNotSupported;
  const CUresult r = fn(reinterpret_cast<CUstream>(stream),
                        reinterpret_cast<CUdeviceptr>(flag), value, flags);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

inline int wait_flag(cudaStream_t stream, void* flag, unsigned value) {
  static const StreamValue32 fn =
      driver_fn<StreamValue32>("cuStreamWaitValue32");
  return stream_value(fn, stream, flag, value, CU_STREAM_WAIT_VALUE_GEQ);
}

inline int write_flag(cudaStream_t stream, void* flag, unsigned value) {
  static const StreamValue32 fn =
      driver_fn<StreamValue32>("cuStreamWriteValue32");
  return stream_value(fn, stream, flag, value, CU_STREAM_WRITE_VALUE_DEFAULT);
}

// A runtime error (>= 0) or a negated driver error, as text.
inline const char* flag_strerror(int err) {
  if (err >= 0) return cudaGetErrorString(static_cast<cudaError_t>(err));
  static const ErrorString fn = driver_fn<ErrorString>("cuGetErrorString");
  const char* msg = nullptr;
  if (!fn || fn(static_cast<CUresult>(-err), &msg) != CUDA_SUCCESS || !msg)
    return "unknown CUDA driver error";
  return msg;
}

}  // namespace stream_flags
