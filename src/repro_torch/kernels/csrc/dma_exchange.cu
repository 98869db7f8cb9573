// K3: one FiCCO chunk exchange step, driven on the copy engines.
//
// Replaces the TPU kernel repro/kernels/dma_exchange.py::a2a_chunk_exchange
// (body _exchange_kernel): every rank writes its (m_c, K) chunk into slot
// `me` of every rank's (g, m_c, K) step buffer, the local slot by a local
// copy; the result equals all_gather(axis=0).  On the TPU the ICI DMA
// engines move the bytes; the paper did the same on MI300X with
// hipMemcpyDtoDAsync on a side stream.  Here each (sender, slot) pair is
// one cudaMemcpyAsync device-to-device on the stream the caller gives (the
// port's dedicated copy stream), so the copy engines move the bytes and no
// SM cycle does: a __global__ copy loop would bring back the compute
// interference that the paper offloads away.
//
// What bounds it: bytes.  A step writes g*g chunks and reads g, all in
// device memory on one card, so its bound is that traffic over the card's
// memory rate; across cards it becomes the NVLink rate.  The design takes
// per-rank pointers, not one tensor: on one card they are the logical
// ranks' buffers, and with peer-mapped buffers over NVLink the same
// function issues the same copies.
//
// Issue order follows _exchange_kernel (dma_exchange.py:61-80): for each
// sender, its local slot first, then peers me+i (me+g-i when `reverse`),
// i = 1..g-1.  Every pair writes a distinct slot, so the order changes
// when bytes move, never the result.

#include <cuda_runtime.h>

// src[r]: rank r's chunk; dst[r * g + s]: slot s of rank r's step buffer.
extern "C" int dma_exchange(
    void* const* src, void* const* dst, long long nbytes, int g,
    int reverse, void* stream) {
  if (g < 1 || nbytes < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int me = 0; me < g; ++me) {
    cudaError_t err = cudaMemcpyAsync(dst[me * g + me], src[me], nbytes,
                                      cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
    for (int i = 1; i < g; ++i) {
      const int peer = (me + (reverse ? g - i : i)) % g;
      err = cudaMemcpyAsync(dst[peer * g + me], src[me], nbytes,
                            cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

extern "C" const char* dma_exchange_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
