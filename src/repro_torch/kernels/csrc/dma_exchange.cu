// K3: one FiCCO chunk exchange step, driven on the copy engines.
//
// Replaces the TPU kernel repro/kernels/dma_exchange.py::a2a_chunk_exchange
// (body _exchange_kernel): every rank writes its (m_c, K) chunk into slot
// `me` of every rank's (g, m_c, K) step buffer, the local slot by a local
// copy; the result equals all_gather(axis=0).  On the TPU the ICI DMA
// engines move the bytes; the paper did the same on MI300X with
// hipMemcpyDtoDAsync on a side stream.  Here every copy is a
// device-to-device cudaMemcpy*Async on streams the caller gives (the port's
// copy streams), so the copy engines move the bytes and no SM cycle does:
// a __global__ copy loop would bring back the compute interference that
// the paper offloads away.  Every rank's step buffer is written in full
// (g x g chunks), because across cards each of those chunks is an NVLink
// transfer.
//
// What bounds it: bytes.  A step writes g*g chunks and reads g, all in
// device memory on one card, so its bound is that traffic over the card's
// memory rate; across cards it becomes the NVLink rate.  What cost the
// first version its time was not the bytes but the copies: g*g of them one
// after another on one stream, each with its own set-up on the host and on
// the engine (16 copies of 512 KB took about 15 x the bytes' time on an
// H100).
//
// What the design does about it: two routes, which the Python wrapper
// picks from the operands and names; each entry point below is one route
// and refuses (cudaErrorInvalidValue) operands it cannot take.
//  * strided: the senders' chunks sit at one stride (on one card, chunk s
//    of every rank is a view of one tensor) and each receiver's slots at
//    another, so one 2D copy fills all g slots of a receiver: height g,
//    width one chunk, source pitch the sender stride, destination pitch
//    the slot stride.  g copies per step instead of g*g, addressed here
//    from two base pointers and three strides.
//  * pairs: one copy per (sender, slot) through pointer tables, for
//    buffers that are not at one stride (peer-mapped NVLink buffers, each
//    rank's its own allocation).  Issue order follows _exchange_kernel
//    (dma_exchange.py:61-80): for each sender its local slot first, then
//    peers me+i (me+g-i when `reverse`), i = 1..g-1.
// Both spread their copies over the given streams by receiver, so the
// copies can run on several copy engines at once: streams[1..n) are forked
// from streams[0] by an event and joined back into it, so work queued on
// streams[0] after the call sees every copy done.  `reverse` orders the
// receivers (0, g-1, ..., 1 instead of 0, 1, ..., g-1); every copy writes
// distinct bytes, so order changes when bytes move, never the result.
//
// Across processes (a group whose ranks are processes, one card each or
// sharing one): one call is rank `me`'s half of _exchange_kernel, its
// local copy and its g-1 pushes (dma_exchange_push), each on its own
// stream as above, into step buffers that every rank exported and its
// peers mapped (peer_memory.cu).  The TPU kernel's send and receive
// semaphores become 32-bit counters in the same memory, driven by stream
// memory operations (stream_flags.cuh), so no host waits and no SM spins:
//  * ready: after its copy into receiver p's slot, the sender writes the
//    step's counter into p's ready flag for it, on the copy's stream (the
//    write lands after the copy).  The receiver's compute stream waits
//    until all g flags reach the counter before its step GEMM.
//  * release: after the GEMM, the receiver writes the step's counter into
//    each sender's release flag for it.  A sender waits on its release
//    flag before it overwrites that slot two steps later (depth-2 ring).
//    Counters rise across calls, so nothing waits on the host between
//    steps or calls.
// With a card per rank each push is a peer copy over NVLink on the
// sender's copy engines, and its ready counter crosses the same link after
// it.  On four H100s every receiver saw a push's bytes once it saw its
// counter, over 50 exchanges with the inputs changing, so the waits carry
// no CU_STREAM_WAIT_VALUE_FLUSH (those cards do not offer it either).
// Driver errors come back negated (-CUresult), the runtime's as they are
// (cudaError_t); dma_exchange_strerror reads both.

#include <cuda_runtime.h>

#include "stream_flags.cuh"

namespace {

constexpr int MAX_STREAMS = 16;
constexpr int MAX_DEVICES = 64;

// Fork/join events, per host thread and device (an event is recorded on a
// stream of its own device).  Reusing one is safe: a wait takes the event's
// most recent record at the time it is enqueued.
thread_local cudaEvent_t events[MAX_DEVICES][MAX_STREAMS] = {};

// The j-th receiver in issue order, and the receiver's place in it (the
// map is its own inverse).
inline int receiver(int j, int g, int reverse) {
  return reverse ? (g - j) % g : j;
}

// Forks streams[1..n) from streams[0], calls `issue(stream_at)`, where
// stream_at(j) is the stream of the receiver in place j of the issue order
// (stream j % n), and joins the streams back into streams[0].
template <typename Issue>
int fan_out(void* const* streams, int n, Issue issue) {
  if (n < 1 || n > MAX_STREAMS) return cudaErrorInvalidValue;
  auto stream = [&](int i) { return static_cast<cudaStream_t>(streams[i]); };
  cudaEvent_t* ev = nullptr;
  cudaError_t err = cudaSuccess;
  if (n > 1) {
    int dev;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    ev = events[dev];
    for (int i = 0; i < n; ++i) {
      if (!ev[i]) {
        err = cudaEventCreateWithFlags(&ev[i], cudaEventDisableTiming);
        if (err != cudaSuccess) return err;
      }
    }
    err = cudaEventRecord(ev[0], stream(0));
    for (int i = 1; err == cudaSuccess && i < n; ++i)
      err = cudaStreamWaitEvent(stream(i), ev[0], 0);
    if (err != cudaSuccess) return err;
  }
  const int issued = issue([&](int j) { return stream(j % n); });
  for (int i = 1; i < n; ++i) {
    cudaError_t e = cudaEventRecord(ev[i], stream(i));
    if (e == cudaSuccess) e = cudaStreamWaitEvent(stream(0), ev[i], 0);
    if (err == cudaSuccess) err = e;
  }
  return issued != 0 ? issued : err;
}

}  // namespace

// The strided route.  Rank s's chunk (`width` contiguous bytes) is at
// src + s * src_rank; slot s of rank r's step buffer at dst + r * dst_rank
// + s * dst_slot (strides in bytes).  One 2D copy per receiver r: g rows
// of `width` bytes, source pitch src_rank, destination pitch dst_slot.
extern "C" int dma_exchange_strided(
    const void* src, long long src_rank, void* dst, long long dst_rank,
    long long dst_slot, long long width, int g, int reverse,
    void* const* streams, int n_streams) {
  if (g < 1 || width < 1 || src_rank < width || dst_slot < width)
    return cudaErrorInvalidValue;
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  return fan_out(streams, n_streams, [&](auto stream_at) {
    for (int j = 0; j < g; ++j) {
      const int r = receiver(j, g, reverse);
      const cudaError_t err =
          cudaMemcpy2DAsync(d + r * dst_rank, dst_slot, s, src_rank, width,
                            g, cudaMemcpyDeviceToDevice, stream_at(j));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  });
}

// The pairs route.  src[r]: rank r's chunk; dst[r * g + s]: slot s of rank
// r's step buffer; `width` bytes each.  Sender-major issue order, as the
// TPU kernel's; each copy on its receiver's stream.
extern "C" int dma_exchange_pairs(
    void* const* src, void* const* dst, long long width, int g, int reverse,
    void* const* streams, int n_streams) {
  if (g < 1 || width < 1) return cudaErrorInvalidValue;
  return fan_out(streams, n_streams, [&](auto stream_at) {
    for (int me = 0; me < g; ++me) {
      for (int i = 0; i < g; ++i) {  // i = 0: the local slot
        const int peer = (me + (reverse ? g - i : i)) % g;
        const cudaError_t err = cudaMemcpyAsync(
            dst[peer * g + me], src[me], width, cudaMemcpyDeviceToDevice,
            stream_at(receiver(peer, g, reverse)));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    return 0;
  });
}

// Rank `me`'s half of one step across processes.  src: its (contiguous)
// chunk of `width` bytes; dst[p]: slot `me` of rank p's step buffer
// (dst[me] its own, the others mapped from p's exported memory);
// ready[p]: p's ready flag for `me`, set to ready_value after the copy;
// release[p]: `me`'s release flag for receiver p, which must reach
// release_value before the copy overwrites p's slot (0: no wait, the
// ring's first two steps).  Issue order as the pairs route's sender `me`:
// the local slot, then peers me+i (me+g-i when `reverse`); the copy to
// the receiver in place i, its wait and its flag on stream i % n_streams.
extern "C" int dma_exchange_push(
    const void* src, void* const* dst, long long width, int g, int me,
    int reverse, void* const* ready, unsigned ready_value,
    void* const* release, unsigned release_value, void* const* streams,
    int n_streams) {
  if (g < 1 || me < 0 || me >= g || width < 1) return cudaErrorInvalidValue;
  return fan_out(streams, n_streams, [&](auto stream_at) {
    for (int i = 0; i < g; ++i) {
      const int peer = (me + (reverse ? g - i : i)) % g;
      const cudaStream_t s = stream_at(i);
      int err = release_value
                    ? stream_flags::wait_flag(s, release[peer], release_value)
                    : 0;
      if (err) return err;
      err = static_cast<int>(cudaMemcpyAsync(
          dst[peer], src, width, cudaMemcpyDeviceToDevice, s));
      if (err) return err;
      err = stream_flags::write_flag(s, ready[peer], ready_value);
      if (err) return err;
    }
    return 0;
  });
}

extern "C" int dma_copy_engines(int* n) {
  int dev;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrAsyncEngineCount, dev);
}

extern "C" const char* dma_exchange_strerror(int err) {
  return stream_flags::flag_strerror(err);
}
